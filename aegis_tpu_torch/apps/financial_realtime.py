"""Financial Realtime — dual-phase v2 UI (reference financial_app_realtime.py):
Phase 1 analysis on the card, cached in session_state; Phase 2 instant
re-extraction on the host on every slider change, its own main=green /
safe=pink SVG piano roll and articulation metric cards.

    streamlit run aegis_tpu_torch/apps/financial_realtime.py
"""

from __future__ import annotations

from aegis_tpu_torch.apps.common import (phase1_cache_key, require_streamlit,
                                         svg_panel)
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.midi.encode import events_to_midi_financial
from aegis_tpu_torch.viz.piano_roll import events_to_svg


def main(device="cuda") -> None:
    """One Streamlit run of the app; the engine runs on ``device``
    ("cuda", the default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Financial Realtime", layout="wide")
    st.title("📈 Aegis TPU — Financial Realtime")

    upload = st.file_uploader("Audio", type=["wav", "mp3", "ogg", "flac"])
    if upload is None:
        return
    file_bytes = upload.getvalue()
    engine = st.session_state.setdefault(
        "fin_engine", AegisFinancialEngine(sample_rate=22050, device=device))

    with st.sidebar:
        rake = st.slider("Rake sensitivity", 0.1, 1.0, 0.6, 0.05)
        guitar_filters = st.checkbox("Guitar-specific filters", True)
        turbo = st.checkbox("Turbo (sharded tiles)", False)
        from aegis_tpu_torch.models.pitchnet import have_default_weights

        neural = (st.checkbox("Neural pitch tracker (PitchNet)", False)
                  if have_default_weights() else False)
        auto_thr = st.checkbox("Adaptive confidence threshold", True)
        conf = None if auto_thr else st.slider("Confidence", 0.1, 0.95, 0.30)
        gate = st.slider("Noise gate (dB)", -80, -10, -40)
        min_dur = st.slider("Min duration (ms)", 10, 500, 50, 10)
        sustain = st.slider("Sustain (ms)", 0, 1000, 50, 10)
        harmonic = st.checkbox("Harmonic (key/scale) filter", True)

    key = phase1_cache_key(file_bytes, rake=rake, gf=guitar_filters,
                           turbo=turbo, neural=neural)
    if st.session_state.get("fin_key") != key:
        with st.status("Financial analysis on device…"):
            analysis = engine.analyze(
                file_bytes, rake_sensitivity=rake,
                use_guitar_filters=guitar_filters, turbo_mode=turbo,
                pitch_backend="neural" if neural else "pyin")
        st.session_state["fin_key"] = key
        st.session_state["fin_analysis"] = analysis
    analysis = st.session_state["fin_analysis"]
    if analysis is None:
        st.error("Empty audio")
        return

    events, info = engine.extract_events(
        analysis, confidence_threshold=conf, noise_gate_db=gate,
        min_note_duration_ms=min_dur, sustain_ms=sustain,
        use_harmonic_filter=harmonic,
    )
    midi_bytes = events_to_midi_financial(events, engine.sr,
                                          engine.hop_length, output=None)

    svg_panel(st, events_to_svg(events, engine.sr, engine.hop_length,
                                title=f"{len(events)} events"))

    main_n = sum(1 for e in events if e["track"] == "main")
    artics = [e.get("financial_artic") for e in events]
    c = st.columns(5)
    c[0].metric("Events", len(events))
    c[1].metric("Main %", f"{main_n / max(len(events), 1):.0%}")
    c[2].metric("Threshold", f"{info['threshold']:.3f}")
    c[3].metric("Bends", sum(1 for a in artics if a == "bend"))
    c[4].metric("Vibratos", sum(1 for a in artics if a == "vibrato"))
    if info.get("key_info"):
        k = info["key_info"]
        st.caption(f"Detected key: **{k['key']} {k['mode']}** "
                   f"(confidence {k['confidence']:.2f})")

    st.download_button("⬇ MIDI", midi_bytes, "aegis_financial.mid",
                       "audio/midi")


if __name__ == "__main__":
    main()
