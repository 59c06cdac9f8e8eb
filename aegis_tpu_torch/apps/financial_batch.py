"""Financial batch studio — one-shot v2 conversion UI with the reference's
full result breadth: metric cards, per-track piano rolls, articulation
analysis, original-vs-MIDI comparison players and an offline-playable MIDI
preview (merges the reference's financial_app.py:140-264 and
financial_app_realtime.py:297-314 surfaces; the CDN <midi-player> preview
is replaced by the framework's ADSR-rendered offline embed).  The analysis
and both renders run on the card.

    streamlit run aegis_tpu_torch/apps/financial_batch.py
"""

from __future__ import annotations

from aegis_tpu_torch.apps.common import (audio_player, require_streamlit,
                                         svg_panel)
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.synth.fluidsynth import synthesize_midi
from aegis_tpu_torch.viz.piano_roll import events_to_svg, render_piano_roll


def main(device="cuda") -> None:
    """One Streamlit run of the app; the engine and the renders run on
    ``device`` ("cuda", the default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Financial Studio", layout="centered")
    st.title("🏦 Aegis TPU — Financial Studio")
    st.caption("Bollinger + MACD + RSI + harmonic analysis, one-shot")

    upload = st.file_uploader("Audio", type=["wav", "mp3", "ogg", "flac"])
    if upload is None:
        return

    with st.sidebar:
        conf = st.slider("Confidence threshold (0 = adaptive)",
                         0.0, 1.0, 0.0, 0.05)
        min_dur = st.slider("Min note duration (ms)", 20, 200, 50, 10)

    if st.button("🚀 Convert"):
        sr = 22050
        engine = AegisFinancialEngine(sample_rate=sr, device=device)
        with st.status("Running 5-phase pipeline…"):
            analysis = engine.analyze(upload.getvalue())
            if analysis is None:
                st.error("Could not decode the upload")
                return
            events, info = engine.extract_events(
                analysis,
                confidence_threshold=(conf or None),
                min_note_duration_ms=float(min_dur))
        if not events:
            st.error("No notes detected")
            return
        import io as _io

        from aegis_tpu_torch.midi.encode import events_to_midi_financial

        buf = _io.BytesIO()
        events_to_midi_financial(events, sr, engine.hop_length,
                                 bpm=info.get("bpm"), output=buf)
        midi_bytes = buf.getvalue()

        # ------------------------------------------------ metric cards
        main_ev = [e for e in events if e.get("track") == "main"]
        safe_ev = [e for e in events if e.get("track") != "main"]
        pct = 100.0 * len(main_ev) / max(len(events), 1)
        a, b, c, d = st.columns(4)
        a.metric("Total Notes", len(events))
        b.metric("Main Track", f"{len(main_ev)} ({pct:.1f}%)")
        c.metric("Safe Track", len(safe_ev))
        thr = info.get("threshold") if isinstance(info, dict) else None
        d.metric("Threshold", f"{thr:.2f}" if thr is not None else "adaptive")

        # ------------------------------------- per-track piano rolls
        st.subheader("🎹 Piano rolls")
        hop = engine.hop_length
        tab1, tab2 = st.tabs(["Main Track", "Safe Track"])
        for tab, evs, name in ((tab1, main_ev, "Main"),
                               (tab2, safe_ev, "Safe")):
            with tab:
                if evs:
                    svg_panel(st, events_to_svg(
                        evs, sr, hop, title=f"{name}: {len(evs)} notes"))
                else:
                    st.warning(f"{name} track: no notes")

        # ------------------------------------- articulation analysis
        counts: dict = {}
        for e in events:
            t = e.get("financial_artic") or e.get("technique")
            if t:
                counts[t] = counts.get(t, 0) + 1
        if counts:
            st.markdown("---")
            st.subheader("🎸 Financial articulation analysis")
            ca, cb, cc = st.columns(3)
            ca.metric("🔺 Bend (Bollinger)", counts.get("bend", 0))
            cb.metric("〰️ Vibrato (Bollinger)", counts.get("vibrato", 0))
            cc.metric("📊 Slide (MACD)", counts.get("slide", 0))

        # ------------------------------------------------- compare
        st.subheader("Compare")
        audio_player(st, upload.getvalue(), "Original")
        wav = synthesize_midi(midi_bytes, sample_rate=sr, device=device)
        if wav:
            audio_player(st, wav, "MIDI rendering")

        st.markdown("### 🎵 MIDI preview (offline playable)")
        st.components.v1.html(
            render_piano_roll(midi_bytes, engine="tonejs", offline=True,
                              device=device),
            height=480)
        st.download_button("⬇ MIDI", midi_bytes, "financial.mid",
                           "audio/midi")


if __name__ == "__main__":
    main()
