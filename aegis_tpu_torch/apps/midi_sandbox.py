"""Multi-engine MIDI sandbox — renders any .mid through all four visualizer
engines with a theme switcher (reference midi_sandbox.py).

    streamlit run aegis_tpu_torch/apps/midi_sandbox.py
"""

from __future__ import annotations

from aegis_tpu_torch.apps.common import require_streamlit, svg_panel
from aegis_tpu_torch.viz.piano_roll import render_piano_roll


def main(device="cuda") -> None:
    """One Streamlit run of the app; an ADSR audio embed, where asked for,
    renders on ``device`` ("cuda", the default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="MIDI Sandbox", layout="wide")
    st.title("🧪 MIDI Visualizer Sandbox")

    upload = st.file_uploader("MIDI file", type=["mid", "midi"])
    engine = st.selectbox(
        "Engine", ["svg", "html_midi_player", "tonejs", "webaudiofont"])
    if upload is None:
        return
    markup = render_piano_roll(upload.getvalue(), engine=engine,
                               device=device)
    svg_panel(st, markup, height=420)
    st.download_button("⬇ markup", markup, f"roll_{engine}.html")


if __name__ == "__main__":
    main()
