"""Aegis Tuning Center — the main v1 UI (reference aegis_app.py), on the
card.

Two-phase workflow: Phase 1 (device analysis) runs once per
(file, range, rake, turbo, stem, neural) key and is cached in
session_state; Phase 2 re-extracts events on the host on every slider
move, so a rerun that moves only a Phase-2 slider launches nothing on the
card.  Includes analysis modes (turbo / zen / stem separation, HPSS on the
card where Demucs is missing), spectrogram view, event table, ASCII tab
with technique symbols, and the rake-ratio report (aegis_app.py:41-103,
284-456).

    streamlit run aegis_tpu_torch/apps/tuning_center.py
"""

from __future__ import annotations

import io
import os

import numpy as np

from aegis_tpu_torch.apps.common import (phase1_cache_key, require_streamlit,
                                         svg_panel)
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.midi.tabs import generate_tabs, render_ascii_tab
from aegis_tpu_torch.viz.piano_roll import events_to_svg

_AUDIO_EXT = (".wav", ".mp3", ".ogg", ".flac")


def _archive_files() -> list:
    """Previously collected audio (tools.collectors layout: per-artist
    subfolders under the collection root).  Reference aegis_app.py:115-140."""
    roots = [
        os.environ.get("AEGIS_ARCHIVE_DIR", ""),
        "collected_audio",
        os.path.expanduser("~/Downloads/AEGIS_COLLECTION"),
    ]
    found = []
    for root in filter(None, roots):
        if not os.path.isdir(root):
            continue
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                if n.lower().endswith(_AUDIO_EXT):
                    found.append(os.path.join(dirpath, n))
    return found


def main(device="cuda") -> None:
    """One Streamlit run of the app; the engine and the stem separation
    run on ``device`` ("cuda", the default, raises without a card)."""
    st = require_streamlit()
    st.set_page_config(page_title="Aegis Tuning Center", layout="wide")
    st.title("🎸 Aegis TPU — Tuning Center")

    with st.sidebar:
        st.header("Input source")
        app_mode = st.radio("Perception input",
                            ["📤 Manual upload", "📂 Archive explorer"])

        st.header("Analysis modes")
        turbo = st.checkbox("Turbo (sharded tiles)", value=False)
        zen = st.checkbox("Zen mode (minimal UI)", value=False)
        use_stem = st.checkbox("Stem separation (Demucs, or on-device HPSS)",
                               value=False)
        from aegis_tpu_torch.models.pitchnet import have_default_weights

        neural = (st.checkbox("Neural pitch tracker (PitchNet)", value=False)
                  if have_default_weights() else False)

        st.header("Phase 1 — Perception")
        rake_sens = st.slider("Rake sensitivity", 0.1, 1.0, 0.6, 0.05)

        st.header("Phase 2 — Logic filter")
        conf = st.slider("Confidence", 0.1, 0.95, 0.30, 0.01)
        gate = st.slider("Noise gate (dB)", -80, -10, -40, 1)
        min_dur = st.slider("Min duration (ms)", 10, 500, 60, 10)
        sustain = st.slider("Sustain merge (ms)", 0, 1000, 150, 10)
        program = st.number_input("MIDI program", 0, 127, 27)

    file_bytes = None
    file_label = "aegis"
    if app_mode == "📂 Archive explorer":
        # Streamlit reruns the whole script on EVERY widget interaction;
        # re-os.walk()ing a large collection per slider tick makes the UI
        # drag.  Cache the listing per session; the refresh button rescans.
        if ("archive_files" not in st.session_state
                or st.sidebar.button("🔄 Rescan archives")):
            st.session_state["archive_files"] = _archive_files()
        archive = st.session_state["archive_files"]
        if not archive:
            st.sidebar.warning("No files found in archives "
                               "(set AEGIS_ARCHIVE_DIR).")
            return
        pick = st.sidebar.selectbox("Archived target", archive,
                                    format_func=os.path.basename)
        with open(pick, "rb") as fh:
            file_bytes = fh.read()
        file_label = os.path.basename(pick)
        st.sidebar.success("Archived target locked.")
    else:
        upload = st.file_uploader("Audio file",
                                  type=[e[1:] for e in _AUDIO_EXT])
        if upload is None:
            st.info("Upload a guitar recording to begin.")
            return
        file_bytes = upload.getvalue()
        file_label = upload.name

    # ---- region-select player (reference aegis_app.py:188-281):
    # audition the take, then confine the analysis to the selected region
    import hashlib

    fkey = hashlib.sha1(file_bytes).hexdigest()
    if st.session_state.get("dur_key") != fkey:
        from aegis_tpu_torch.io.audio import load_audio, probe_duration

        dur = probe_duration(file_bytes)  # header math / ffprobe, no decode
        if dur is None:  # format without a cheap probe: decode once
            y_probe, sr_probe = load_audio(file_bytes, sr=None)
            dur = len(y_probe) / float(sr_probe)
        st.session_state["dur_key"] = fkey
        st.session_state["duration"] = max(dur, 0.1)
    duration = st.session_state["duration"]

    region = st.slider("Analysis region (s)", 0.0, float(round(duration, 1)),
                       (0.0, float(round(duration, 1))), 0.1)
    try:  # playback from the region start (older streamlit lacks start_time)
        st.audio(file_bytes, start_time=int(region[0]))
    except TypeError:
        st.audio(file_bytes)
    start_time, end_time = region
    if end_time >= round(duration, 1):
        end_time = 0.0  # full-length sentinel (matches the old number input)
    engine = st.session_state.setdefault(
        "engine", AegisEngine(sample_rate=44100, device=device))

    if use_stem:
        # cache the separated stem by upload content: every widget
        # interaction reruns this script, and the HPSS separation is a
        # program on the card
        stem_key = phase1_cache_key(file_bytes, op="stem")
        if st.session_state.get("stem_key") != stem_key:
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".wav",
                                             delete=False) as f:
                f.write(file_bytes)
            with st.status("Separating stems…"):
                stem_path = engine.separate_stems(f.name, tempfile.mkdtemp())
            with open(stem_path, "rb") as sf_:
                st.session_state["stem_bytes"] = sf_.read()
            st.session_state["stem_key"] = stem_key
            os.unlink(f.name)
        file_bytes = st.session_state["stem_bytes"]

    key = phase1_cache_key(file_bytes, start=start_time, end=end_time,
                           rake=rake_sens, turbo=turbo, stem=use_stem,
                           neural=neural)
    if st.session_state.get("p1_key") != key:
        with st.status("Perception Phase (analyze once)…"):
            raw = engine.audio_to_midi(
                file_bytes, None,
                start_time=start_time,
                end_time=end_time or None,
                turbo_mode=turbo,
                rake_sensitivity=rake_sens,
                pitch_backend="neural" if neural else "pyin",
            )
        if raw is None:
            st.error("Empty audio.")
            return
        st.session_state["p1_key"] = key
        st.session_state["raw_data"] = raw
    raw = st.session_state["raw_data"]

    # Phase 2: instant re-filter on the host
    tempo_aware = st.checkbox(
        "Tempo-aware MIDI (set_tempo from the detected BPM)", value=False)
    bpm_est = engine.estimate_bpm(raw) if tempo_aware else None
    buf = io.BytesIO()
    events = engine.extract_events(
        raw, buf,
        confidence_threshold=conf, noise_gate_db=gate,
        min_note_duration_ms=min_dur, sustain_ms=sustain,
        midi_program=int(program),
        bpm=bpm_est,
    )
    midi_bytes = buf.getvalue()

    col1, col2 = st.columns([3, 1])
    with col1:
        svg_panel(st, events_to_svg(events, engine.sr, engine.hop_length,
                                    title=f"{len(events)} events"))
    with col2:
        main_n = sum(1 for e in events if e["track"] == "main")
        st.metric("Events", len(events))
        st.metric("Main / Safe", f"{main_n} / {len(events) - main_n}")
        rake_ratio = float(np.mean(raw["rake_mask"])) if len(raw["rake_mask"]) else 0.0
        st.metric("Rake frames", f"{rake_ratio:.1%}")
        if bpm_est:
            st.metric("Tempo", f"{bpm_est:.1f} BPM")
        mid_name = os.path.splitext(os.path.basename(file_label))[0] + ".mid"
        st.download_button("⬇ MIDI", midi_bytes, mid_name, "audio/midi")

    if not zen:
        st.subheader("Tablature")
        st.code(render_ascii_tab(generate_tabs(events)) or "—")
        st.subheader("Events")
        st.dataframe(
            [{k: e[k] for k in ("note", "start", "end", "confidence",
                                "velocity", "track", "technique")}
             for e in events]
        )
        with st.expander("Spectrogram (mel dB)"):
            st.line_chart(np.asarray(raw["mel_db"]).mean(axis=1))


if __name__ == "__main__":
    main()
