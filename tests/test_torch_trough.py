"""The pYIN trough probabilities and their scatter into pitch bins: the CPU
path (the two loops, the plain version of csrc/trough_obs.cu), the
launch arithmetic of the kernel and its launch count.  The kernel itself
is held to the loops on the card (tests/test_torch_cuda.py,
chip_smoke.py's trough_obs phase).  Imports no JAX."""

import sys
from pathlib import Path

import pytest
import torch

from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import tables_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

# One torch thread per process: the suite runs in parallel pytest workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
H100_SMEM = pyin_cuda.H100_MAX_SHARED_MEMORY

# chip_smoke's gate cases, each with the (B, T) run here (the loops take
# ~14 s a CPU core for the 5 249 rows of a 60 s take) and the rows B T the
# main path launches at that case
CASES = {
    "fused60_44100": ((1, 48), 5249),
    "fused120_44100": ((1, 48), 10497),
    "fused60_44100_n900": ((1, 48), 5249),
    "fused60_44100_n2250": ((1, 48), 5249),
    "fused60_22050": ((1, 48), 2625),
    "live_tile_44100": ((1, 40), 40),
    "tiles_44100": ((6, 8), 6 * 1152),
    "stream_slab_22050": ((16, 4), 16 * 1152),
}


def _case(name):
    sr, res, _ = cs.TROUGH_CASES[name]
    cfg = PyinConfig(resolution=res)
    return sr, cfg, tables_from_numpy(AudioConfig(sample_rate=sr), cfg, CPU)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_cpu_path_is_the_loops_bitwise(name):
    """On a CPU tensor trough_observations is trough_probabilities then
    the per-lag scatter, bit for bit, at each main-path shape's L, n and
    K (a silent row and a falling row give zero rows; the white-noise row
    has a trough every few lags); frame_observations gives the rows the
    stages gave before the kernel, obs and voiced probabilities; and the
    kernel's launch arithmetic takes the shape at the main path's rows."""
    (B, T), rows = CASES[name]
    sr, cfg, tables = _case(name)
    n, L, K = cfg.n_pitch_bins, cs.n_lags(sr, cfg), cfg.n_thresholds

    yin, mask, bins = cs.trough_rows(CPU, sr, cfg, (B, T))
    assert yin.shape == (B, T, L)
    got = tpyin.trough_observations(yin, mask, bins, cfg, tables)
    want = tpyin.scatter_bins(
        tpyin.trough_probabilities(yin.reshape(-1, L), mask.reshape(-1, L),
                                   cfg, tables), bins.reshape(-1, L), n)
    assert got.shape == (B, T, n)
    assert torch.equal(got.reshape(-1, n), want)
    flat = got.reshape(-1, n)
    assert not flat[:2].any() and flat[2].any()
    assert mask.reshape(-1, L)[2].sum() > L // 4

    frames = cs.trough_frames(CPU, sr, cfg, (B, T))
    obs, vprob = tpyin.frame_observations(frames, sr, cfg, tables)
    y2 = tpyin.cmndf_frames(frames.reshape(-1, cfg.frame_length),
                            cfg.win_length, cfg.min_period(sr),
                            cfg.max_period(sr))
    probs = tpyin.trough_probabilities(y2, tpyin.trough_mask(y2), cfg, tables)
    obs_old, vprob_old = tpyin.observations(probs, tpyin.parabolic_shifts(y2),
                                            sr, cfg.min_period(sr), cfg)
    assert obs.shape == (B, T, n) and vprob.shape == (B, T)
    assert torch.equal(obs.reshape(-1, n), obs_old)
    assert torch.equal(vprob.reshape(-1), vprob_old)

    ctas, smem = pyin_cuda.trough_obs_launch(rows, L, n, K, H100_SMEM)
    warps = pyin_cuda.TROUGH_WARPS
    assert ctas * warps >= rows > (ctas - 1) * warps
    assert smem <= 48 * 1024


def test_the_launch_arithmetic_raises_naming_its_limit():
    K, smem = 100, H100_SMEM
    # shared memory: the CTA's tables and each warp's arrays grow with L
    warps = pyin_cuda.TROUGH_WARPS
    fits = max(L for L in range(1, 5000)
               if 4 * (2 * (K + L) + warps * (3 * L + 2 * K)) <= smem)
    assert pyin_cuda.trough_obs_launch(7, fits, 450, K, smem)[1] <= smem
    with pytest.raises(ValueError, match="shared memory"):
        pyin_cuda.trough_obs_launch(7, fits + 1, 450, K, smem)
    with pytest.raises(ValueError, match="shared memory"):
        pyin_cuda.trough_obs_launch(7, 526, 450, 100, 16 * 1024)
    for bad in ((0, 526, 450, K), (5, 0, 450, K), (5, 526, 0, K),
                (5, 526, 450, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            pyin_cuda.trough_obs_launch(*bad, smem)
    with pytest.raises(ValueError, match="rows"):
        pyin_cuda.trough_obs_launch(2 ** 31, 526, 450, K, smem)


def test_the_kernel_takes_no_cpu_tensor_and_the_cpu_path_builds_nothing(
        monkeypatch):
    sr, cfg, tables = _case("live_tile_44100")
    yin, mask, bins = cs.trough_rows(CPU, sr, cfg, (1, 40))

    def no_build():
        raise AssertionError("the CPU path built the kernel")

    monkeypatch.setattr(pyin_cuda, "trough_library", no_build)
    tpyin.trough_observations(yin, mask, bins, cfg, tables)
    with pytest.raises(ValueError, match="CUDA kernel"):
        pyin_cuda.trough_obs(yin, mask, bins, tables.thresholds,
                             tables.beta_probs, cfg.n_pitch_bins,
                             cfg.boltzmann_parameter, cfg.no_trough_prob)


def test_a_trough_launch_counts_its_sequences_and_shape(monkeypatch):
    """Counted as the Viterbi kernels are: once a launch, B sequences, at
    (B, T, L, n); recorded inside a capture and counted a replay."""
    for name in ("LAUNCHES", "LAST_BATCH", "SEQUENCES"):
        monkeypatch.setattr(pyin_cuda, name,
                            {k: 0 for k in pyin_cuda.LAUNCHES})
    monkeypatch.setattr(pyin_cuda, "SHAPES",
                        {k: {} for k in pyin_cuda.LAUNCHES})
    shape = (6, 1152, 526, 450)
    with pyin_cuda.recording_launches() as launched:
        pyin_cuda._count("trough_obs", shape)
    assert pyin_cuda.LAUNCHES["trough_obs"] == 0
    for _ in range(2):
        pyin_cuda.count_launches(launched)
    assert pyin_cuda.LAUNCHES["trough_obs"] == 2
    assert pyin_cuda.SEQUENCES["trough_obs"] == 12
    assert pyin_cuda.LAST_BATCH["trough_obs"] == 6
    assert pyin_cuda.SHAPES["trough_obs"] == {shape: 2}


def test_the_trough_library_binds_once_under_concurrent_first_callers(
        monkeypatch):
    """The REST server's handler threads may reach the kernel first
    together: one build and one binding a process, the same library for
    every caller."""
    import threading
    import time
    import types

    calls = {"build": 0, "bind": 0}
    lock = threading.Lock()

    def slow_build(source):
        assert source == pyin_cuda.TROUGH_SOURCE
        with lock:
            calls["build"] += 1
        time.sleep(0.2)
        return Path("libaegis_trough_obs_fake.so")

    def bind(path):
        with lock:
            calls["bind"] += 1
        return types.SimpleNamespace(aegis_trough_obs=types.SimpleNamespace())

    monkeypatch.setattr(pyin_cuda, "_TROUGH_LIB", None)
    monkeypatch.setattr(pyin_cuda, "build", slow_build)
    monkeypatch.setattr(pyin_cuda.ctypes, "CDLL", bind)
    barrier = threading.Barrier(8)
    got = []

    def first_call():
        barrier.wait(timeout=30)
        got.append(pyin_cuda.trough_library())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert calls == {"build": 1, "bind": 1}
    assert len(got) == 8 and all(g is got[0] for g in got)
