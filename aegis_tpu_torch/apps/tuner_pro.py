"""Aegis Tuner Pro — power-user UI wiring in every advanced module
(reference aegis_tuner_pro.py), on the card: auto-match, technique
verification, crossfader, ADSR synth with envelope match, effect learning
loop with a history chart, and the per-note optimizer.  Analysis is capped
to the first 30 s (aegis_tuner_pro.py:63) and runs the tiled program.

Every tab runs the port's ``verify/`` and ``synth/`` modules on the
engine's device; where the JAX package's loops skip a step that raises,
the port's raise (no fallback hides the card).  Without FluidSynth the
crossfade renders with the ADSR synth on the card.

    streamlit run aegis_tpu_torch/apps/tuner_pro.py
"""

from __future__ import annotations

import io

import numpy as np

from aegis_tpu_torch.apps.common import (audio_player, phase1_cache_key,
                                         require_streamlit, svg_panel)
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.synth.adsr import analyze_envelope, synthesize_midi_adsr
from aegis_tpu_torch.synth.fluidsynth import synthesize_midi
from aegis_tpu_torch.synth.presets import EFFECT_PRESETS, GUITAR_ADSR_PRESETS
from aegis_tpu_torch.viz.piano_roll import events_to_svg


def main(device="cuda") -> None:
    """One Streamlit run of the app; the analysis, the loops and the renders
    run on ``device`` ("cuda", the default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Tuner Pro", layout="wide")
    st.title("🎛 Aegis TPU — Tuner Pro")

    upload = st.file_uploader("Audio (first 30 s analyzed)",
                              type=["wav", "mp3", "ogg", "flac"])
    if upload is None:
        return
    file_bytes = upload.getvalue()
    engine = st.session_state.setdefault(
        "engine", AegisEngine(sample_rate=44100, device=device))
    dev = engine.device

    from aegis_tpu_torch.models.pitchnet import have_default_weights

    neural = (st.sidebar.checkbox("Neural pitch tracker (PitchNet)", False)
              if have_default_weights() else False)
    key = phase1_cache_key(file_bytes, cap=30, neural=neural)
    if st.session_state.get("pro_key") != key:
        with st.status("Analyzing (turbo, first 30 s)…"):
            raw = engine.audio_to_midi(
                file_bytes, None, end_time=30.0,
                turbo_mode=not neural,
                pitch_backend="neural" if neural else "pyin")
        st.session_state["pro_key"] = key
        st.session_state["pro_raw"] = raw
    raw = st.session_state["pro_raw"]

    conf = st.sidebar.slider("Confidence", 0.1, 0.95, 0.30, 0.01)
    min_dur = st.sidebar.slider("Min duration (ms)", 10, 500, 60, 10)
    sustain = st.sidebar.slider("Sustain (ms)", 0, 1000, 150, 10)
    verify_tech = st.sidebar.checkbox("Verify techniques by audio matching")

    buf = io.BytesIO()
    events = engine.extract_events(raw, buf, confidence_threshold=conf,
                                   min_note_duration_ms=min_dur,
                                   sustain_ms=sustain)
    midi_bytes = buf.getvalue()

    if verify_tech and events:
        from aegis_tpu_torch.verify.technique import (
            verify_technique_by_audio_matching)

        with st.status("Verifying techniques…"):
            events = verify_technique_by_audio_matching(
                raw["y"], events, engine.sr, engine.hop_length, device=dev)

    svg_panel(st, events_to_svg(events, engine.sr, engine.hop_length))
    st.download_button("⬇ MIDI", midi_bytes, "aegis_pro.mid", "audio/midi")

    tab_match, tab_fade, tab_rev, tab_adsr, tab_fx, tab_opt = st.tabs(
        ["Auto-match", "Crossfader", "Reverse", "ADSR synth",
         "Effect loop", "Per-note"]
    )

    with tab_match:
        if st.button("🔍 Auto-match parameters (54 combos)"):
            from aegis_tpu_torch.verify.auto_match import auto_match_parameters

            prog = st.progress(0.0)
            res = auto_match_parameters(
                raw["y"], engine, raw, sample_rate=engine.sr,
                progress_callback=lambda p, m: prog.progress(p, m),
            )
            st.json(res)

    with tab_fade:
        fade = st.slider("Original ↔ Synth", 0.0, 1.0, 0.5, 0.05)
        if st.button("Render crossfade"):
            wav = synthesize_midi(midi_bytes, sample_rate=engine.sr,
                                  device=dev)
            if wav:
                from aegis_tpu_torch.io.wav import read_wav, write_wav

                y_m, _ = read_wav(wav)
                if y_m.ndim == 2:
                    y_m = y_m.mean(axis=1)
                n = min(len(raw["y"]), len(y_m))
                mix = (1 - fade) * raw["y"][:n] + fade * y_m[:n]
                out = io.BytesIO()
                write_wav(out, mix / max(np.abs(mix).max(), 1e-9) * 0.9,
                          engine.sr)
                audio_player(st, out.getvalue())

    with tab_rev:
        if st.button("🔄 Reverse analysis"):
            from aegis_tpu_torch.verify.reverse import reverse_analysis

            res = reverse_analysis(midi_bytes, engine, sample_rate=engine.sr)
            if res:
                c1, c2, c3 = st.columns(3)
                c1.metric("Note accuracy", f"{res['note_accuracy']:.1%}")
                c2.metric("Pitch accuracy", f"{res['pitch_accuracy']:.1%}")
                c3.metric("Timing accuracy", f"{res['timing_accuracy']:.1%}")

    with tab_adsr:
        preset = st.selectbox("Preset", list(GUITAR_ADSR_PRESETS))
        match_env = st.checkbox("Match original envelope")
        if st.button("Synthesize (ADSR)"):
            overrides = analyze_envelope(raw["y"], engine.sr) if match_env else {}
            wav = synthesize_midi_adsr(midi_bytes, preset=preset,
                                       sample_rate=engine.sr, device=dev,
                                       **overrides)
            audio_player(st, wav)
            if overrides:
                st.json(overrides)

    with tab_fx:
        preset = st.selectbox("Effect preset", list(EFFECT_PRESETS))
        iters = st.slider("Max iterations", 1, 10, 5)
        if st.button("▶ Run learning loop"):
            from aegis_tpu_torch.verify.effect_loop import learning_loop

            res = learning_loop(midi_bytes, engine, preset=preset,
                                max_iterations=iters, sample_rate=engine.sr)
            if res:
                st.json(res["best_params"])
                st.line_chart(
                    [h["accuracy"]["overall"] for h in res["history"]]
                )

    with tab_opt:
        mode = st.radio("Mode", ["quick", "precise"], horizontal=True)
        if st.button("⚙ Optimize every note"):
            from aegis_tpu_torch.verify.per_note import (
                generate_optimization_report, optimize_all_notes,
                synthesize_with_per_note_params)

            prog = st.progress(0.0)
            params = optimize_all_notes(
                raw["y"], events, engine.sr, engine.hop_length, mode=mode,
                progress_callback=lambda p, m: prog.progress(p, m),
                device=dev,
            )
            st.json(generate_optimization_report(params))
            audio = synthesize_with_per_note_params(events, params, engine.sr,
                                                    engine.hop_length,
                                                    device=dev)
            from aegis_tpu_torch.io.wav import write_wav

            out = io.BytesIO()
            write_wav(out, audio, engine.sr)
            audio_player(st, out.getvalue(), "Per-note optimized synthesis")


if __name__ == "__main__":
    main()
