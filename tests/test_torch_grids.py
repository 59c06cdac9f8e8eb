"""Finer pitch grids (``PyinConfig.resolution`` 0.05 and 0.04 semitone a
bin: n = 900 and 1125 states) on the CPU, against the JAX package, and the
forward kernel's launch rule for every grid the JAX decode takes.

On the CPU the Viterbi wrappers take their plain versions, so what runs
here is the decode's semantics at these grids; tests/test_torch_cuda.py
holds the kernels to the same plain versions on the card.  Tolerances are
those of tests/test_torch_pyin.py and tests/test_torch_realtime.py:
states equal, f0 within 1e-4 relative where both are voiced (the same bin
through two frequency tables), events equal with floats within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aegis_tpu.config import AudioConfig as JAudioConfig
from aegis_tpu.config import PyinConfig as JPyinConfig
from aegis_tpu.core import pyin as jpyin
from aegis_tpu.engine.realtime import StreamingTranscriber as JaxStreaming
from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import tables_from_numpy
from aegis_tpu_torch.engine.realtime import StreamingTranscriber
from aegis_tpu_torch.tools.signal_gen import generate_test_track

# One torch thread per process: the suite runs in parallel pytest workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
HOP = 512
# (resolution, rate): n = 900 / 1125 states, w = 101 / 201 and 126 / 251
FINER = [(0.05, 44100), (0.05, 22050), (0.04, 44100), (0.04, 22050)]
# every (resolution, rate, hop) of the table of pitch grids: n from 450 to
# 2250, w from 51 to 501
GRID_TABLE = [(res, sr, hop) for res in (0.1, 0.05, 0.04, 0.03, 0.02)
              for sr, hop in ((22050, 512), (44100, 512), (44100, 1024),
                              (22050, 256))]


def _clip(sr: int, seconds: float = 2.0) -> np.ndarray:
    """The first seconds of the Karplus-Strong test track at ``sr``."""
    return generate_test_track(sr=sr)[0][: int(seconds * sr)]


@pytest.mark.parametrize("res,sr", FINER)
def test_pyin_equals_jax_on_finer_grids(res, sr):
    y = _clip(sr)
    f0j, vfj, vpj = (np.asarray(a) for a in
                     jpyin.pyin(y, sr, HOP, JPyinConfig(resolution=res)))
    f0t, vft, vpt = (a.numpy() for a in
                     tpyin.pyin(y, sr, HOP, PyinConfig(resolution=res),
                                device="cpu"))
    assert vft.any()
    np.testing.assert_array_equal(vft, vfj)
    m = vft & vfj
    assert np.max(np.abs(f0t[m] - f0j[m]) / f0j[m]) < 1e-4
    assert np.max(np.abs(vpt - vpj)) < 1e-4


@pytest.mark.parametrize("res,sr", FINER)
def test_decode_states_equal_jax_on_finer_grids(res, sr):
    """frame_observations -> _decode_states: the port's states are the JAX
    decode's on the same observations, state for state."""
    cfg = PyinConfig(resolution=res)
    tables = tables_from_numpy(AudioConfig(sample_rate=sr, hop_length=HOP),
                               cfg, CPU)
    assert tables.band.shape == (cfg.n_pitch_bins, 2 * tables.half_width + 1)
    y = torch.from_numpy(_clip(sr))
    frames = tpyin.extract_pyin_frames(y, HOP, cfg)
    obs, vprob = tpyin.frame_observations(frames, sr, cfg, tables)
    got = tpyin._decode_states(obs[None], vprob[None], tables, cfg)[0].numpy()
    jcfg = JPyinConfig(resolution=res)
    ref = np.asarray(jpyin._decode_states(
        jnp.asarray(obs.numpy()), jnp.asarray(vprob.numpy()),
        jcfg.transition_width(sr, HOP), jcfg))
    assert tables.half_width == jcfg.transition_width(sr, HOP)
    assert (got < cfg.n_pitch_bins).any()
    np.testing.assert_array_equal(got, ref)


def test_live_session_equals_jax_at_resolution_005():
    """StreamingTranscriber(pyin_cfg=PyinConfig(resolution=0.05)) fed the
    same chunks as the JAX one: every tile's voicing equal, its f0 the
    same bins (within 1e-6 relative: the two frequency tables of this grid
    round a few bins one float32 step apart), the finalized events equal
    (floats within the live tests' tolerances)."""
    sr = 22050
    y = _clip(sr, 4.0)
    kw = {"confidence_threshold": 0.5, "tile_frames": 24, "halo_frames": 8}
    jx = JaxStreaming(audio=JAudioConfig(sample_rate=sr),
                      pyin_cfg=JPyinConfig(resolution=0.05), **kw)
    pt = StreamingTranscriber(audio=AudioConfig(sample_rate=sr),
                              pyin_cfg=PyinConfig(resolution=0.05),
                              device="cpu", **kw)
    for i in range(0, len(y), 5000):
        jx.feed(y[i:i + 5000])
        pt.feed(y[i:i + 5000])
    assert len(pt._rows) == len(jx._rows) >= 3
    f0, voiced = pt._rows_spec.index("f0"), pt._rows_spec.index("voiced_flag")
    for got, ref in zip(pt._rows, jx._rows):
        np.testing.assert_array_equal(got[:, voiced], ref[:, voiced])
        # the same bins: their frequencies within a float32 step or two
        np.testing.assert_allclose(got[:, f0], ref[:, f0], rtol=1e-6)
    events_t, events_j = pt.finalize(), jx.finalize()
    assert events_t
    assert len(events_t) == len(events_j)
    for g, r in zip(events_t, events_j):
        assert g.keys() == r.keys()
        for key in r:
            if isinstance(r[key], float):
                assert abs(g[key] - r[key]) <= 1e-5, (key, g, r)
            else:
                assert g[key] == r[key], (key, g, r)


# ------------------------------------------------------------ the launch rule

@pytest.mark.parametrize("res,sr,hop", GRID_TABLE)
def test_launch_rule_takes_every_grid(res, sr, hop):
    """pick_forward_variant accepts every grid of the table for B = 1..64
    on 132 SMs, returns forward_launch's arithmetic for the variant it
    picks, and never a variant over 512 threads, the one-pass kernel's 32
    warps or the H100's shared memory."""
    cfg = PyinConfig(resolution=res)
    n, w = cfg.n_pitch_bins, cfg.transition_width(sr, hop)
    smem = pyin_cuda.H100_MAX_SHARED_MEMORY
    for B in range(1, 65):
        launch = pyin_cuda.pick_forward_variant(B, 132, n, w, smem)
        tile, cluster = launch.tile, launch.cluster
        assert launch == pyin_cuda.forward_launch(n, w, tile, cluster, smem)
        assert launch.threads <= pyin_cuda.FWD_MAX_THREADS
        assert launch.threads % 32 == 0
        assert launch.smem_bytes <= smem
        # every tile of the CTA gets a lane group in one of the passes
        tiles_per_cta = -(-(-(-n // 8)) // cluster)
        lanes = 8 if tile == 88 else 16
        assert launch.passes * launch.threads >= tiles_per_cta * lanes
        if not launch.wide:
            assert launch.passes == 1
            assert launch.warps <= pyin_cuda.FWD_ONE_PASS_WARPS
            assert launch.threads >= tiles_per_cta * lanes


def _launch_today(B: int, n: int):
    """The rule before the wide kernel: (tile, cluster) by B alone, one
    tile a thread within 512 threads and 32 warps a cluster."""
    tile, cluster = ((96, 8) if 16 * B <= 132 else
                     next(((88, c) for c in (4, 2) if c * B <= 132), (88, 1)))
    lanes = 8 if tile == 88 else 16
    threads = (-(-(-(-n // 8)) // cluster) * lanes + 31) // 32 * 32
    return (tile, cluster), threads


@pytest.mark.parametrize("n,w", [(1, 0), (150, 101), (450, 51), (450, 101),
                                 (450, 200), (512, 101), (512, 251)])
def test_launch_rule_keeps_the_one_pass_kernel_up_to_512_states(n, w):
    smem = pyin_cuda.H100_MAX_SHARED_MEMORY
    for B in range(1, 129):
        launch = pyin_cuda.pick_forward_variant(B, 132, n, w, smem)
        today, threads = _launch_today(B, n)
        assert (launch.tile, launch.cluster) == today
        assert not launch.wide and launch.threads == threads


def test_launch_rule_names_the_limit():
    smem = pyin_cuda.H100_MAX_SHARED_MEMORY
    with pytest.raises(ValueError, match="shared memory"):
        pyin_cuda.pick_forward_variant(1, 132, 20000, 51, smem)
    with pytest.raises(ValueError, match="n >= 1"):
        pyin_cuda.forward_launch(0, 51, 88, 1, smem)
    with pytest.raises(ValueError, match="tile"):
        pyin_cuda.forward_launch(450, 51, 7, 1, smem)
    # the largest grid of the table: the wide kernel, table in global memory
    launch = pyin_cuda.forward_launch(2250, 501, 88, 1, smem)
    assert launch.wide and launch.passes == 5 and not launch.table_in_smem


@pytest.mark.parametrize("B,T,n,w", [(2, 40, 900, 101), (1, 30, 2250, 501)])
def test_backtrace_plain_versions_agree_on_finer_grids(B, T, n, w):
    """The backtrace kernels' chunked algorithm at 2n up to 4500 states
    equals the frame-by-frame walk (the maps scratch is (B, K, 2n))."""
    rng = np.random.default_rng(n + w)
    psi_v = torch.from_numpy(rng.integers(0, 2 * n, (B, T, n), dtype=np.int32))
    psi_u = torch.from_numpy(rng.integers(0, 2 * n, (B, T, n), dtype=np.int32))
    psi_v[:, 0] = 0
    psi_u[:, 0] = 0
    d_last = torch.from_numpy(rng.standard_normal((B, 2, n)).astype(np.float32))
    ref = pyin_cuda.viterbi_back_plain(d_last, psi_v, psi_u)
    for chunk in (7, pyin_cuda.BACK_CHUNK):
        assert torch.equal(pyin_cuda.viterbi_back_chunked_plain(
            d_last, psi_v, psi_u, chunk), ref)
