"""The port's Tuner Pro against the JAX package's, on the CPU: one scripted
session through both apps (the turbo analysis of the upload, then one
rerun a tab button), each rerun's record compared as in
``tests/test_torch_apps.py``; the tab results also against direct calls of
the port's loops on the same inputs.  A file of its own, for it is the
heaviest app session (``--dist loadfile`` puts a file on one worker)."""

import io

import pytest
import torch

from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.tools.signal_gen import generate_test_track
from test_torch_apps import _both, _chip_smoke, _same_logs, _wav

torch.set_num_threads(1)

AUTO_MATCH = "🔍 Auto-match parameters (54 combos)"
RERUNS = {
    "analysis": {},
    "verify_techniques": {"Verify techniques by audio matching": True},
    "auto_match": {"Verify techniques by audio matching": False,
                   AUTO_MATCH: True},
    "crossfade": {AUTO_MATCH: False, "Render crossfade": True,
                  "Original ↔ Synth": 0.3},
    "reverse": {"Render crossfade": False, "🔄 Reverse analysis": True},
    "adsr": {"🔄 Reverse analysis": False, "Synthesize (ADSR)": True,
             "Match original envelope": True, "Preset": "steel"},
    # the learning loop cut to two iterations
    "effect_loop": {"Synthesize (ADSR)": False, "▶ Run learning loop": True,
                    "Effect preset": "light_overdrive", "Max iterations": 2},
    "per_note": {"▶ Run learning loop": False, "⚙ Optimize every note": True,
                 "Mode": "quick"},
}


@pytest.fixture(scope="module")
def session():
    cs = _chip_smoke()
    upload = cs.Upload(_wav(generate_test_track(sr=44100)[0], 44100),
                       "ks_track.wav")
    st_p, _, logs = _both("tuner_pro",
                          {"Audio (first 30 s analyzed)": upload},
                          reruns=tuple(RERUNS.values()))
    return st_p, dict(zip(RERUNS, logs)), upload


@pytest.mark.parametrize("rerun", list(RERUNS))
def test_tuner_pro_matches_jax(session, rerun):
    _, logs, _ = session
    port_log, jax_log = logs[rerun]
    _same_logs(port_log, jax_log)
    names = [n for n, _, _ in port_log]
    assert names[:4] == ["set_page_config", "title", "html",
                         "download_button"]


def test_tuner_pro_results_equal_the_direct_calls(session):
    """The analysis is the 30 s turbo call of the facade; the auto-match,
    reverse, learning-loop and per-note results are those of the port's
    loops called directly on the same inputs."""
    from aegis_tpu_torch.verify.auto_match import auto_match_parameters
    from aegis_tpu_torch.verify.effect_loop import learning_loop
    from aegis_tpu_torch.verify.per_note import (generate_optimization_report,
                                                 optimize_all_notes)
    from aegis_tpu_torch.verify.reverse import reverse_analysis

    _, logs, upload = session
    cs = _chip_smoke()
    eng = AegisEngine(sample_rate=44100, device="cpu")
    raw = eng.audio_to_midi(upload.getvalue(), None, end_time=30.0,
                            turbo_mode=True)
    buf = io.BytesIO()
    events = eng.extract_events(raw, buf, confidence_threshold=0.30,
                                min_note_duration_ms=60, sustain_ms=150)
    midi = buf.getvalue()
    assert cs.outputs(logs["analysis"][0], "download_button") == [
        ("⬇ MIDI", midi, "aegis_pro.mid", "audio/midi")]

    (res,), = cs.outputs(logs["auto_match"][0], "json")
    assert res == auto_match_parameters(raw["y"], eng, raw, sample_rate=44100)
    rev = reverse_analysis(midi, eng, sample_rate=44100)
    assert [a[1] for a in cs.outputs(logs["reverse"][0], "metric")] == [
        f"{rev[k]:.1%}" for k in ("note_accuracy", "pitch_accuracy",
                                  "timing_accuracy")]
    loop = learning_loop(midi, eng, preset="light_overdrive",
                         max_iterations=2, sample_rate=44100)
    assert cs.outputs(logs["effect_loop"][0], "json") == [
        (loop["best_params"],)]
    params = optimize_all_notes(raw["y"], events, 44100, eng.hop_length,
                                mode="quick", device="cpu")
    assert cs.outputs(logs["per_note"][0], "json") == [
        (generate_optimization_report(params),)]
