"""Stem Lab — standalone Demucs runner UI with model choice and 4-stem
playback/download (reference stem_lab_app.py).  Without the Demucs binary
the HPSS separator runs on the card.

    streamlit run aegis_tpu_torch/apps/stem_lab.py
"""

from __future__ import annotations

import os
import tempfile

from aegis_tpu_torch.apps.common import audio_player, require_streamlit
from aegis_tpu_torch.synth.stems import (DEMUCS_MODELS, find_demucs,
                                         separate_all_stems, separate_hpss)


def main(device="cuda") -> None:
    """One Streamlit run of the app; HPSS runs on ``device`` ("cuda", the
    default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="Stem Lab", layout="centered")
    st.title("🥁 Stem Lab")

    have_demucs = find_demucs() is not None
    if not have_demucs:
        st.info("Demucs binary not found (PATH / $AEGIS_DEMUCS_BIN); "
                "the on-device HPSS separator is available instead.")

    choices = (list(DEMUCS_MODELS) if have_demucs else []) + ["hpss (on-device)"]
    model = st.selectbox("Model", choices)
    upload = st.file_uploader("Audio", type=["wav", "mp3", "flac"])
    if upload is None or st.button("Separate") is False:
        return

    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        f.write(upload.getvalue())
    with st.status("Separating…"):
        if model.startswith("hpss"):
            harm = separate_hpss(f.name, tempfile.mkdtemp(), device=device)
            stem_dir = os.path.dirname(harm)
            stems = [os.path.join(stem_dir, n)
                     for n in ("other.wav", "drums.wav")]
        else:
            stems = separate_all_stems(f.name, tempfile.mkdtemp(), model=model)
    os.unlink(f.name)
    if not stems:
        st.error("Separation failed.")
        return
    for path in stems:
        name = os.path.basename(path)
        with open(path, "rb") as sf_:
            data = sf_.read()
        audio_player(st, data, name)
        st.download_button(f"⬇ {name}", data, name, "audio/wav")


if __name__ == "__main__":
    main()
