"""Live Monitor — feed an upload through the port's LIVE streaming
transcribers chunk by chunk and watch the event list grow, exactly as a
microphone or network source would drive /api/stream-* (beyond-reference:
the reference has no online mode at all; its closest feature is region
slicing, aegis_app.py:274-281).

The upload is played back in simulated real-time slices so the UI shows
what a live client sees at each poll: the v1/financial engines' causal dB
reference locking in, and the poly engine's retroactively-exact roll.
Works with all three engines (engine.realtime transcribers on the card —
the same objects behind /api/stream-start?engine=... and `python -m
aegis_tpu_torch stream`).

    streamlit run aegis_tpu_torch/apps/live_monitor.py
"""

from __future__ import annotations

import numpy as np

from aegis_tpu_torch.apps.common import require_streamlit, svg_panel
from aegis_tpu_torch.viz.piano_roll import events_to_svg


def make_transcriber(engine_kind: str, sr: int, confidence, device="cuda"):
    """The same construction the server's /api/stream-start does, on
    ``device`` ("cuda", the default, raises without a card)."""
    from aegis_tpu_torch.config import AudioConfig
    from aegis_tpu_torch.engine.realtime import (StreamingPolyTranscriber,
                                                 StreamingTranscriber)

    kw = {}
    if confidence is not None:
        kw["confidence_threshold"] = confidence
    elif engine_kind in ("v1", "poly"):
        # the server's defaults: v1/poly use 0.5; financial stays on its
        # adaptive threshold unless the client sends one
        kw["confidence_threshold"] = 0.5
    if engine_kind == "poly":
        return StreamingPolyTranscriber(sample_rate=sr, device=device, **kw)
    return StreamingTranscriber(audio=AudioConfig(sample_rate=sr),
                                financial=(engine_kind == "financial"),
                                device=device, **kw)


def stream_in_chunks(rt, y: np.ndarray, sr: int, chunk_s: float = 2.0):
    """Generator: feed `chunk_s`-second slices; yield (seconds_fed, events)
    after each poll — the app's render loop and the tests both drive it."""
    step = max(int(chunk_s * sr), 1)
    for pos in range(0, len(y), step):
        rt.feed(y[pos: pos + step])
        yield min(pos + step, len(y)) / sr, rt.poll_events()


def main(device="cuda") -> None:
    """One Streamlit run of the app; the live transcriber runs on
    ``device`` ("cuda", the default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Live Monitor", layout="wide")
    st.title("🔴 Aegis TPU — Live Monitor")
    st.caption("Simulates a live source: the upload is fed in real-time "
               "slices through the online transcribers behind "
               "/api/stream-* and `python -m aegis_tpu_torch stream`.")

    upload = st.file_uploader("Audio", type=["wav", "mp3", "ogg", "flac"])
    with st.sidebar:
        engine_kind = st.radio("Engine", ["v1", "financial", "poly"],
                               horizontal=True)
        auto_thr = st.checkbox("Engine-default confidence", True)
        conf = None if auto_thr else st.slider("Confidence", 0.1, 0.95, 0.5)
        chunk_s = st.slider("Chunk size (s)", 0.5, 5.0, 2.0, 0.5)
    if upload is None:
        return

    from aegis_tpu_torch.io.audio import load_audio

    sr = 22050
    y, _ = load_audio(upload.getvalue(), sr=sr)
    rt = make_transcriber(engine_kind, sr, conf, device=device)
    st.metric("Intrinsic lookahead", f"{rt.lookahead_s:.2f} s")

    panel = st.empty()
    meter = st.empty()
    for fed_s, events in stream_in_chunks(rt, y, sr, chunk_s):
        meter.progress(min(fed_s / (len(y) / sr), 1.0),
                       text=f"{fed_s:.1f} s fed — {len(events)} events live")
        if events:
            hop = getattr(rt, "hop", None) or rt.audio.hop_length
            svg_panel(panel, events_to_svg(events, sr, hop), height=320)

    final = rt.finalize()
    st.success(f"finalized: {len(final)} events")
    if final:
        import io

        from aegis_tpu_torch.midi.encode import events_to_midi

        hop = getattr(rt, "hop", None) or rt.audio.hop_length
        buf = io.BytesIO()
        events_to_midi(final, sr, hop, output=buf)
        st.download_button("Download MIDI", buf.getvalue(), "live.mid")


if __name__ == "__main__":
    main()
