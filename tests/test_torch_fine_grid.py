"""The 5-cent pitch grid as a served deployment (``bench_torch/configs/
v1_fine_44k.json``: pYIN at resolution 0.05, n = 900 states, w = 101 at
44 100 Hz, hop 512) on the CPU: the REST server that
``bench_torch/program.py`` builds from the file answers as the float64
reference does, the grid reaches the program, and the decode's
``aegis.viterbi`` span names the forward kernel the decode launched.
The last test runs the span on the card and skips without one."""

import base64
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from aegis_tpu_torch.config import PyinConfig  # noqa: E402
from aegis_tpu_torch.core import pyin_cuda  # noqa: E402
from aegis_tpu_torch.utils import prof  # noqa: E402
from bench_torch import program, run, takes  # noqa: E402
from bench_torch.checks import v1 as v1_check  # noqa: E402
from bench_torch.checks import v1_grid  # noqa: E402
from bench_torch.reference import host_v1, v1_device  # noqa: E402

FINE = run.load_json(run.HERE / "configs" / "v1_fine_44k.json")
MONO = run.load_json(run.HERE / "configs" / "v1_mono_44k.json")
MIX = run.load_json(run.HERE / "traffic" / "rest_mono_grid.json")
SR = FINE["audio"]["sample_rate"]
SEED = 2**31 + 5
CPU = [torch.profiler.ProfilerActivity.CPU]


def _take(seconds: float = 3.5) -> np.ndarray:
    (_, pcm), = takes.make_takes({"generator": "bench_track",
                                  "lengths_s": [seconds]}, SEED, SR)
    return pcm


def _answer(cfg, pcm):
    """Upload and analyze one take on the server the configuration builds,
    with the cell's rake threshold: the analyze body and the session."""
    srv = program.server(cfg, "cpu", tempfile.mkdtemp(prefix="fine_grid_"))
    up = srv.router.dispatch("POST", "/api/upload", {"name": "take.wav"},
                             takes.wav_bytes(pcm, SR), "audio/wav")
    sid = json.loads(up.content)["session_id"]
    rake = {"rake_sensitivity": repr(cfg["analysis"]["rake_sensitivity"])}
    out = srv.router.dispatch("POST", f"/api/analyze/{sid}", rake, b"",
                              "application/json")
    assert out.status == 200, out.content[:500]
    return json.loads(out.content), srv.sessions.get(sid)


def _bins(rows) -> np.ndarray:
    """Each frame's pitch bin on the n = 900 grid, -1 where unvoiced."""
    p = FINE["pyin"]
    return v1_grid.bins(rows["f0"], rows["voiced_flag"], p["fmin"],
                        round(1 / p["resolution"]))


def _sample(pcm, body, sess) -> dict:
    """One answer as the REST load samples it for the check."""
    return {"take": "take", "pcm": pcm,
            "rows": {k: np.asarray(v) for k, v in sess["raw_data"].items()
                     if k != "y" and np.ndim(v) >= 1},
            "events": [dict(e) for e in sess["events"]],
            "midi": base64.b64decode(body["midi_base64"])}


@pytest.fixture(scope="module")
def fine_answer():
    pcm = _take()
    body, sess = _answer(FINE, pcm)
    return pcm, body, sess, v1_device.analyze(pcm, FINE, "cpu")


def test_the_fine_grid_servers_answer_is_the_references(fine_answer):
    pcm, body, sess, ref = fine_answer
    rows = sess["raw_data"]
    assert len(rows["f0"]) == len(ref["f0"])
    # the pitch grid: every frame's state is the reference's (the decode is
    # exact on either side, and the observations lie far from a tie here)
    assert np.array_equal(_bins(rows), _bins(ref))
    assert np.array_equal(np.asarray(rows["voiced_flag"]),
                          ref["voiced_flag"])
    # float32 against float64: the voiced probability sums 100 threshold
    # masses (a trough on a threshold moves one whole); RMS, onset
    # strength and mel dB are rounding-level (the configuration's limits)
    limits = FINE["check"]["limits"][MIX["check"]]
    sample = _sample(pcm, body, sess)
    got = v1_grid.check([sample], FINE, MIX, "cpu")
    assert set(got) == set(limits)
    for key, value in got.items():
        assert value <= limits[key], (key, value, limits[key])
    # the cell's check reads the same states: no frame's differs
    assert got["state_miss_pct"] == 0
    # every event matched one to one within the configuration's `tol`:
    # start and end within 2 frames (an onset a frame early or late),
    # velocity within 1 (RMS rounding), confidence within 0.002 (a mean
    # of float32 probabilities); and the MIDI the server wrote is the
    # reference encoder's for those events, byte for byte
    assert got["event_miss_pct"] == 0 and got["midi_diff"] == 0
    ref_events = v1_check._events_of(ref, FINE, MIX["extract"])
    assert len(sess["events"]) == len(ref_events) >= 3
    assert host_v1.events_to_midi([dict(e) for e in sess["events"]], SR,
                                  FINE["audio"]["hop_length"],
                                  **MIX["midi"]) == sample["midi"]


def test_the_coarse_grid_misses_the_fine_references_states(fine_answer):
    """The same take through the n = 450 configuration: its states are not
    the n = 900 reference's, so the grid of the file reached the program;
    and the cell's check finds that fault by its states alone, every
    number it shares with the v1 check being within its limit."""
    pcm, _, _, ref = fine_answer
    body, sess = _answer(MONO, pcm)
    assert np.sum(_bins(sess["raw_data"]) != _bins(ref)) >= 5
    limits = FINE["check"]["limits"][MIX["check"]]
    got = v1_grid.check([_sample(pcm, body, sess)], FINE, MIX, "cpu")
    assert got["state_miss_pct"] > limits["state_miss_pct"], got
    assert all(got[k] <= limits[k] for k in got if k != "state_miss_pct"), got


def test_the_decode_span_names_the_plain_decode_on_the_cpu():
    pcm = _take(2.0)
    before = {s.index for s in prof.spans()}
    with torch.profiler.profile(activities=CPU):
        _answer(FINE, pcm)
    got = [s for s in prof.spans()
           if s.index not in before and s.name == "aegis.viterbi"]
    assert len(got) == 1
    a = got[0].attrs
    assert (a["B"], a["n"], a["w"], a["kernel"]) == (1, 900, 101, "plain")
    assert a["T"] >= 1 + len(pcm) // FINE["audio"]["hop_length"]
    assert a["tile"] is a["cluster"] is a["passes"] is None
    # the enqueue's child: the decode is launched with the fused program
    parent = next(s for s in prof.spans() if s.index == got[0].parent)
    assert parent.name == "aegis.enqueue"


def test_off_the_decode_records_no_span():
    before = len([s for s in prof.spans() if s.name == "aegis.viterbi"])
    _answer(FINE, _take(2.0))
    assert len([s for s in prof.spans()
                if s.name == "aegis.viterbi"]) == before


@pytest.mark.parametrize("res,kernel", [(0.05, "viterbi_fwd_wide_kernel"),
                                        (0.1, "viterbi_fwd_kernel")])
def test_the_launch_rule_sends_the_served_grid_to_its_kernel(res, kernel):
    cfg = PyinConfig(resolution=res)
    n, w = cfg.n_pitch_bins, cfg.transition_width(SR, 512)
    launch = pyin_cuda.pick_forward_variant(
        1, 132, n, w, pyin_cuda.H100_MAX_SHARED_MEMORY)
    assert launch.kernel == kernel and launch.wide == (n > 512)
    if res == 0.05:
        # one sequence spreads over a cluster of 8 CTAs: 64 warps, over the
        # one-pass kernel's 32
        assert (n, w) == (900, 101)
        assert launch.warps > pyin_cuda.FWD_ONE_PASS_WARPS


@pytest.mark.cuda
@pytest.mark.parametrize("res", [0.05, 0.1])
def test_the_decode_span_names_the_kernel_that_ran_on_the_card(res,
                                                               monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these on the card")
    from aegis_tpu_torch.core.tables import (band_class_table,
                                             log_transition_band)
    from aegis_tpu_torch.tools.signal_gen import wandering_pitch_obs

    dev = torch.device("cuda")
    cfg = PyinConfig(resolution=res)
    n, w = cfg.n_pitch_bins, cfg.transition_width(SR, 512)
    obs, vprob = wandering_pitch_obs(300, n, 3, n // 2, 8, (-1, 0, 1), True)
    lo_v = torch.log(torch.from_numpy(obs[None]).to(dev) + 1e-30).contiguous()
    lo_u = torch.log((1.0 - torch.from_numpy(vprob[None]).to(dev)) / n
                     + 1e-30).contiguous()
    band_np = log_transition_band(n, w)
    band = torch.from_numpy(band_np).to(dev)
    tab = torch.from_numpy(band_class_table(band_np, n, w)).to(dev)
    stay = float(np.log1p(-cfg.switch_prob))
    switch = float(np.log(cfg.switch_prob))

    def decode():
        return pyin_cuda.viterbi_decode_cuda(lo_v, lo_u, band, n, w, stay,
                                             switch, tab)

    want = decode()
    # the (tile, cluster) each forward launch is made with
    launched = []
    real_launch = pyin_cuda._launch_fwd

    def launch_fwd(*args, **kwargs):
        launched.append(args[7:9])
        return real_launch(*args, **kwargs)

    monkeypatch.setattr(pyin_cuda, "_launch_fwd", launch_fwd)
    launch = pyin_cuda.pick_forward_variant(
        1, torch.cuda.get_device_properties(dev).multi_processor_count, n, w,
        pyin_cuda.max_shared_memory(dev))
    before = {s.index for s in prof.spans()}
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as p:
        states = decode()
        torch.cuda.synchronize()
        # a capture records no span, and its replay runs no Python
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with pyin_cuda.recording_launches(), \
                torch.cuda.graph(graph, stream=side):
            captured = decode()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(states, want) and torch.equal(captured, want)
    got = [s for s in prof.spans()
           if s.index not in before and s.name == "aegis.viterbi"]
    assert len(got) == 1
    a = got[0].attrs
    assert (a["B"], a["T"], a["n"], a["w"]) == (1, 300, n, w)
    assert (a["kernel"], a["tile"], a["cluster"], a["passes"]) == (
        launch.kernel, launch.tile, launch.cluster, launch.passes)
    # the span's launch is the one made, in the traced decode and the capture
    assert launched == [(a["tile"], a["cluster"])] * 2
    ran = {e.name for e in p.events() if "viterbi_fwd" in e.name}
    assert any(launch.kernel in name for name in ran), ran
    other = ({"viterbi_fwd_kernel", "viterbi_fwd_wide_kernel"}
             - {launch.kernel}).pop()
    assert not any(other in name for name in ran), ran
