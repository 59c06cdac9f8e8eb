"""Shared helpers for the Streamlit apps (a copy of
``aegis_tpu/apps/common.py``; the missing-streamlit message names the
port's server)."""

from __future__ import annotations

import hashlib
import io
from typing import Optional


def require_streamlit():
    try:
        import streamlit as st  # noqa: F401

        return st
    except ImportError as e:
        raise ImportError(
            "This app needs streamlit (not part of the core dependency set). "
            "Install it, or use the REST server + SPA instead: "
            "python -m aegis_tpu_torch serve"
        ) from e


def phase1_cache_key(file_bytes: bytes, **params) -> str:
    """Composite key for the analyze-once cache (the reference keys Phase-1
    results on file + every Phase-1 parameter, aegis_app.py:284-323)."""
    h = hashlib.sha1(file_bytes)
    for k in sorted(params):
        h.update(f"{k}={params[k]}".encode())
    return h.hexdigest()


def audio_player(st, wav_bytes: bytes, label: Optional[str] = None) -> None:
    if label:
        st.caption(label)
    st.audio(io.BytesIO(wav_bytes), format="audio/wav")


def svg_panel(st, svg: str, height: int = 360) -> None:
    import streamlit.components.v1 as components

    components.html(svg, height=height + 30, scrolling=False)
