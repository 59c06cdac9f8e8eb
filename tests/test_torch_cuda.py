"""The CUDA Viterbi kernels vs their plain PyTorch versions, the
polyphonic programs, the PitchNet training step and the validate gate vs
the CPU, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aegis_tpu_torch.config import PyinConfig
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import band_class_table, log_transition_band
from aegis_tpu_torch.tools.signal_gen import wandering_pitch_obs

CFG = PyinConfig()
N = CFG.n_pitch_bins
LOG_STAY = float(np.log1p(-CFG.switch_prob))
LOG_SWITCH = float(np.log(CFG.switch_prob))

# (half-width, batch of (T, seed, center, step, spread, jumps)[, states]);
# w = 150 is wider than the TPU kernel's 256 Hankel rows could hold
CASES = {
    "w101": (101, [(40, 11, 200, 8, (-2, -1, 0, 1, 2), True)]),
    "w51": (51, [(32, 21, 150, 4, (0,), False)]),
    "w150_batch3": (150, [(48, 5, 220, 20, (-1, 0, 1), True),
                          (48, 6, 100, 3, (0,), True),
                          (48, 7, 400, 9, (0, 1), False)]),
    "t1": (101, [(1, 3, 200, 8, (0,), False)]),
    "t2_batch2": (51, [(2, 3, 200, 8, (0,), False),
                       (2, 4, 100, 8, (0, 1), True)]),
    # fewer states than one band: every source is clipped on both sides
    "narrow_n150_w101": (101, [(70, 8, 75, 8, (-1, 0, 1), True),
                               (70, 9, 40, 5, (0,), True)], 150),
    # a score table too large for shared memory: read from global memory
    "wide_w200": (200, [(40, 12, 220, 20, (-1, 0, 1), True)]),
    # the streamed mode's slab: sixteen haloed tiles at 22 050 Hz
    "stream_b16_w101": (101, [(1152, 50 + i, 60 + 20 * i, 6, (-1, 0, 1), True)
                              for i in range(16)]),
    # a tile batch as the tiled program launches it at 44 100 Hz: six
    # haloed 1024 + 2*64 frame tiles, one CTA each
    "tiles_b6_w51": (51, [(1152, 30 + i, 100 + 50 * i, 6, (-1, 0, 1), True)
                          for i in range(6)]),
    # one live tile a launch: tile + 2 * halo frames at the (24, 8) and the
    # (64, 32) presets, both rates (the backtrace has one chunk / two chunks)
    "live_t40_w101": (101, [(40, 61, 210, 8, (-1, 0, 1), True)]),
    "live_t128_w101": (101, [(128, 62, 180, 8, (-2, 0, 2), True)]),
    "live_t40_w51": (51, [(40, 63, 230, 4, (-1, 0, 1), True)]),
    "live_t128_w51": (51, [(128, 64, 120, 4, (0, 1), True)]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_kernels_equal_plain(cuda, case):
    width, seqs, *states = CASES[case]
    N = states[0] if states else CFG.n_pitch_bins
    pairs = [wandering_pitch_obs(T, N, *rest) for T, *rest in seqs]
    obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(cuda)
    vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(cuda)
    lo_v = torch.log(obs + 1e-30).contiguous()
    lo_u = torch.log((1.0 - vprob) / N + 1e-30).contiguous()
    band_np = log_transition_band(N, width)
    band = torch.from_numpy(band_np).to(cuda)
    tab = torch.from_numpy(band_class_table(band_np, N, width)).to(cuda)

    before = dict(pyin_cuda.LAUNCHES)
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, N, width,
                                                 LOG_STAY, LOG_SWITCH, tab)
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    torch.cuda.synchronize()
    assert pyin_cuda.LAUNCHES["viterbi_fwd"] == before["viterbi_fwd"] + 1
    assert pyin_cuda.LAUNCHES["viterbi_back"] == before["viterbi_back"] + 1

    p_v, p_u, p_last = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(band, N, width),
        LOG_STAY, LOG_SWITCH)
    assert torch.equal(psi_v, p_v) and torch.equal(psi_u, p_u)
    assert torch.equal(d_last, p_last)
    assert torch.equal(states, pyin_cuda.viterbi_back_plain(p_last, p_v, p_u))
    # the table built from the band inside the wrapper gives the same
    no_tab = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, N, width, LOG_STAY,
                                   LOG_SWITCH)
    assert all(torch.equal(a, b) for a, b in zip(no_tab, (p_v, p_u, p_last)))


@pytest.mark.cuda
def test_trough_kernel_equals_the_loops_at_every_main_path_batch(cuda):
    """trough_obs_kernel against the threshold loop and the per-lag
    scatter it replaces, on the card, at every row batch of the main path
    (chip_smoke.TROUGH_CASES: fused 60 s and 120 s at 44 100 Hz, n = 450,
    900 and 2250, 22 050 Hz, a live tile, the turbo tiles, the stream's
    slab), each with a silent row, a row without troughs and a white-noise
    row: obs and voiced probabilities bitwise, eager and replayed in a CUDA
    graph, one launch counted at (B, T, L, n)."""
    rows = _chip_smoke().phase_trough_obs(cuda)
    assert len(rows) == len(_chip_smoke().TROUGH_CASES)
    assert all(r["rows_differing"] == 0 for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", pyin_cuda.FWD_TILES)
def test_every_forward_variant_equals_plain(cuda, tile):
    """Each destination tile the library is built with, at every cluster
    size, and the table read from global memory, on the tiled program's shape at
    22 050 Hz."""
    width = 101
    pairs = [wandering_pitch_obs(300, N, 70 + b, 150 + 40 * b, 8,
                                 (-2, -1, 0, 1, 2), True) for b in range(3)]
    obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(cuda)
    vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(cuda)
    lo_v = torch.log(obs + 1e-30).contiguous()
    lo_u = torch.log((1.0 - vprob) / N + 1e-30).contiguous()
    band_np = log_transition_band(N, width)
    band = torch.from_numpy(band_np).to(cuda)
    tab = torch.from_numpy(band_class_table(band_np, N, width)).to(cuda)
    plain = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(band, N, width),
        LOG_STAY, LOG_SWITCH)
    clusters = [c for c in pyin_cuda.FWD_CLUSTERS if tile != 96 or c > 1]
    smem = pyin_cuda.max_shared_memory(cuda)
    for in_smem, cluster in [(True, c) for c in clusters] + [
            (False, clusters[0])]:
        got = pyin_cuda._launch_fwd(lo_v, lo_u, tab, N, width, LOG_STAY,
                                    LOG_SWITCH, tile, cluster,
                                    smem if in_smem else 0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), (
            in_smem, cluster)


# the finer pitch grids of PyinConfig.resolution 0.05, 0.04 and 0.02 at
# 44 100 / 44 100 / 22 050 Hz, hop 512: (n, w), past the one-pass kernel
GRIDS = [(900, 101), (1125, 126), (2250, 501)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("n,width", GRIDS)
def test_viterbi_kernels_equal_plain_on_finer_grids(cuda, n, width, B):
    """Both kernels at n = 900, 1125 and 2250 states, through the wrappers
    (the cluster they pick) and every variant of the forward kernel (one to
    eight CTAs, both tiles, the table in global memory): backpointers,
    final delta and states identical to the plain versions."""
    T = 96 if B == 1 else 40
    pairs = [wandering_pitch_obs(T, n, 80 + b, 100 + (n - 200) * b // 16, 12,
                                 (-2, -1, 0, 1, 2), True) for b in range(B)]
    obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(cuda)
    vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(cuda)
    lo_v = torch.log(obs + 1e-30).contiguous()
    lo_u = torch.log((1.0 - vprob) / n + 1e-30).contiguous()
    band_np = log_transition_band(n, width)
    band = torch.from_numpy(band_np).to(cuda)
    tab = torch.from_numpy(band_class_table(band_np, n, width)).to(cuda)
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, width,
                                                 LOG_STAY, LOG_SWITCH, tab)
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    torch.cuda.synchronize()
    p_v, p_u, p_last = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(band, n, width),
        LOG_STAY, LOG_SWITCH)
    assert torch.equal(psi_v, p_v) and torch.equal(psi_u, p_u)
    assert torch.equal(d_last, p_last)
    assert torch.equal(states, pyin_cuda.viterbi_back_plain(p_last, p_v, p_u))
    smem = pyin_cuda.max_shared_memory(cuda)
    for tile in pyin_cuda.FWD_TILES:
        for cluster in pyin_cuda.FWD_CLUSTERS:
            for limit in (smem, 0):
                got = pyin_cuda._launch_fwd(lo_v, lo_u, tab, n, width,
                                            LOG_STAY, LOG_SWITCH, tile,
                                            cluster, limit)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b)
                           for a, b in zip(got, (p_v, p_u, p_last))), (
                    tile, cluster, limit)


def _most_states(w: int, tile: int, cluster: int, smem: int) -> int:
    """The largest n one variant of the forward kernel takes at band
    half-width w (forward_launch's shared-memory limit)."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            pyin_cuda.forward_launch(mid, w, tile, cluster, smem)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("width", [51, 501])
def test_viterbi_kernels_equal_plain_at_the_shared_memory_limit(cuda, width,
                                                                 B):
    """The forward kernel at the most states its delta buffers let it take
    (about 10 400 at w = 501 and 11 300 at w = 51 on an H100, in 6 to 23
    passes of a CTA's threads):
    every variant at the largest n all of them take, and the wrappers at
    the largest n of the variant they pick, identical to the plain
    versions; one state more raises before any launch."""
    smem = pyin_cuda.max_shared_memory(cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    variants = [(t, c) for t in pyin_cuda.FWD_TILES
                for c in pyin_cuda.FWD_CLUSTERS]
    most = {v: _most_states(width, *v, smem) for v in variants}
    T = 16 if B == 1 else 6

    def inputs(n):
        pairs = [wandering_pitch_obs(T, n, 90 + b, 100 + (n - 200) * b // 16,
                                     12, (-2, -1, 0, 1, 2), True)
                 for b in range(B)]
        obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(cuda)
        vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(cuda)
        band_np = log_transition_band(n, width)
        return (torch.log(obs + 1e-30).contiguous(),
                torch.log((1.0 - vprob) / n + 1e-30).contiguous(),
                torch.from_numpy(band_np).to(cuda),
                torch.from_numpy(band_class_table(band_np, n, width)).to(cuda))

    def plain(lo_v, lo_u, band, n):
        return pyin_cuda.viterbi_fwd_plain(
            lo_v, lo_u, pyin_cuda.dense_from_band(band, n, width),
            LOG_STAY, LOG_SWITCH)

    n = min(most.values())
    lo_v, lo_u, band, tab = inputs(n)
    want = plain(lo_v, lo_u, band, n)
    for tile, cluster in variants:
        launch = pyin_cuda.forward_launch(n, width, tile, cluster, smem)
        assert launch.wide and not launch.table_in_smem
        got = pyin_cuda._launch_fwd(lo_v, lo_u, tab, n, width, LOG_STAY,
                                    LOG_SWITCH, tile, cluster, smem)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            n, tile, cluster, launch.passes)
    del want

    picked = pyin_cuda.pick_forward_variant(B, n_sms, n, width, smem)
    n = most[(picked.tile, picked.cluster)]
    lo_v, lo_u, band, tab = inputs(n)
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, width,
                                                 LOG_STAY, LOG_SWITCH, tab)
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    torch.cuda.synchronize()
    p_v, p_u, p_last = plain(lo_v, lo_u, band, n)
    assert torch.equal(psi_v, p_v) and torch.equal(psi_u, p_u)
    assert torch.equal(d_last, p_last)
    assert torch.equal(states, pyin_cuda.viterbi_back_plain(p_last, p_v, p_u))
    del p_v, p_u, p_last
    before = dict(pyin_cuda.LAUNCHES)
    over = torch.zeros((B, T, n + 1), device=cuda)
    band = torch.from_numpy(log_transition_band(n + 1, width)).to(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pyin_cuda.viterbi_fwd(over, lo_u, band, n + 1, width, LOG_STAY,
                              LOG_SWITCH)
    assert pyin_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_viterbi_kernel_rejects_what_it_cannot_take(cuda):
    band = torch.from_numpy(log_transition_band(N, 51)).to(cuda)
    lo_v = torch.zeros((1, 8, N), device=cuda)
    lo_u = torch.zeros((1, 8), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        pyin_cuda.viterbi_fwd(lo_v.double(), lo_u, band, N, 51, 0.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        pyin_cuda.viterbi_fwd(lo_v.transpose(1, 2).contiguous().transpose(1, 2),
                              lo_u, band, N, 51, 0.0, 0.0)
    # any n whose delta buffers fit shared memory: 20 000 states do not
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((1, 8, 20000), device=cuda)
        pyin_cuda.viterbi_fwd(wide, lo_u, band, 20000, 51, 0.0, 0.0)
    with pytest.raises(ValueError, match="tab"):   # a table of another width
        other = torch.from_numpy(band_class_table(
            log_transition_band(N, 101), N, 101)).to(cuda)
        pyin_cuda.viterbi_fwd(lo_v, lo_u, band, N, 51, 0.0, 0.0, other)
    with pytest.raises(ValueError, match="frames"):
        long = torch.zeros((1, pyin_cuda.MAX_FRAMES + 1, 2), device=cuda)
        pyin_cuda.viterbi_fwd(long, long[:, :, 0].contiguous(),
                              torch.zeros((2, 1), device=cuda), 2, 0, 0.0, 0.0)
    tab = torch.from_numpy(band_class_table(
        log_transition_band(N, 51), N, 51)).to(cuda)
    with pytest.raises(ValueError, match="tile"):
        pyin_cuda._launch_fwd(lo_v, lo_u, tab, N, 51, 0.0, 0.0, 7, 1, 0)


def _changed(lo_v, lo_u, how):
    lo_v, lo_u = lo_v.clone(), lo_u.clone()
    T, n = lo_v.shape[1:]
    if how == "one_observation_zero":
        lo_v[:, T // 2, n // 3] = 0.0
    elif how == "all_above_zero":
        lo_v += 9.0
        lo_u += 9.0
    elif how == "half_the_states_minus_inf":
        lo_v[:, :, : n // 2] = -float("inf")
    elif how == "a_frame_of_minus_inf":
        lo_v[:, 2] = -float("inf")
        lo_u[:, 2] = -float("inf")
    return lo_v, lo_u


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["one_observation_zero", "all_above_zero",
                                 "half_the_states_minus_inf",
                                 "a_frame_of_minus_inf"])
def test_forward_kernel_takes_scores_that_are_no_log_probabilities(cuda, how):
    """Scores of either sign give the plain version's results, and -inf
    (a destination none of whose in-band sources scores, a whole frame
    without a score) leaves the first-index rule whole."""
    width = 51
    pairs = [wandering_pitch_obs(90, N, 80 + b, 120 + 90 * b, 8,
                                 (-2, -1, 0, 1, 2), True) for b in range(2)]
    obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(cuda)
    vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(cuda)
    lo_v, lo_u = _changed(torch.log(obs + 1e-30),
                          torch.log((1.0 - vprob) / N + 1e-30), how)
    band_np = log_transition_band(N, width)
    band = torch.from_numpy(band_np).to(cuda)
    tab = torch.from_numpy(band_class_table(band_np, N, width)).to(cuda)
    plain = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(band, N, width),
        LOG_STAY, LOG_SWITCH)
    got = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, N, width, LOG_STAY,
                                LOG_SWITCH, tab)
    one_cta = pyin_cuda._launch_fwd(lo_v, lo_u, tab, N, width, LOG_STAY,
                                    LOG_SWITCH, 88, 1,
                                    pyin_cuda.max_shared_memory(cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert all(torch.equal(a, b) for a, b in zip(one_cta, plain))
    states = pyin_cuda.viterbi_back(*got[2:], *got[:2])
    assert torch.equal(states, pyin_cuda.viterbi_back_plain(
        plain[2], plain[0], plain[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("financial", [False, True], ids=["v1", "financial"])
def test_live_session_launches_each_kernel_once_a_tile(cuda, financial):
    """The live transcriber on the card: one launch of each kernel a tile at
    B = 1, events equal to the same session on the CPU by note, start and
    end, and the discrete rows on at least 0.99 of the frames (the card's
    matmuls sum in another order, so a frame on a decision edge may flip)."""
    from aegis_tpu_torch.config import AudioConfig
    from aegis_tpu_torch.engine.realtime import StreamingTranscriber
    from aegis_tpu_torch.tools.signal_gen import generate_test_track

    y, _ = generate_test_track(sr=22050)
    kw = {"financial": True} if financial else {"confidence_threshold": 0.5}
    sessions = {}
    for dev in ("cuda", "cpu"):
        rt = StreamingTranscriber(audio=AudioConfig(sample_rate=22050),
                                  device=dev, **kw)
        for counts in (pyin_cuda.LAUNCHES, pyin_cuda.SEQUENCES):
            for k in counts:
                counts[k] = 0
        for i in range(0, len(y), 7000):
            rt.feed(y[i:i + 7000])
        assert rt.poll_events() == rt._poll_full()
        events = rt.finalize()
        n = len(rt._rows) if dev == "cuda" else 0
        assert pyin_cuda.LAUNCHES == pyin_cuda.SEQUENCES == {
            "viterbi_fwd": n, "viterbi_back": n, "trough_obs": n}
        sessions[dev] = (np.concatenate(rt._rows), events)
    (rows_g, ev_g), (rows_c, ev_c) = sessions["cuda"], sessions["cpu"]
    assert ev_g and [(e["note"], e["start"], e["end"]) for e in ev_g] == \
        [(e["note"], e["start"], e["end"]) for e in ev_c]
    for i, k in enumerate(rt._rows_spec):
        if k in ("f0", "voiced_flag", "rake_mask", "mute_mask"):
            same = np.isclose(rows_g[:, i], rows_c[:, i], rtol=1e-6,
                              equal_nan=True)
            assert same.mean() >= 0.99, (k, same.mean())


# ------------------------------------------- the live tile program's graph

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["v1_44100", "v1_22050", "financial_44100",
                                  "v1_n900_44100"])
def test_live_graph_replays_equal_the_eager_body(cuda, case):
    """A 20 s session fed a tile at a time replays one captured graph a
    tile: every tile's rows and running reference bitwise those of the
    tile program's body run eagerly on the same slabs, each kernel counted
    once a tile at its shape (the warm-up and the capture count nothing)."""
    from aegis_tpu_torch.config import AudioConfig
    from aegis_tpu_torch.core.tables import tables_from_numpy
    from aegis_tpu_torch.tools.signal_gen import generate_bench_track

    cs = _chip_smoke()
    _, sr, financial, cfg = next(c for c in cs.LIVE_GRAPH_CASES
                                 if c[0] == case)
    y = generate_bench_track(20.0, sr=sr)
    cs.reset_counts()
    graph = cs.graph_session(cuda, y, sr, financial, cfg)
    w = tables_from_numpy(AudioConfig(sample_rate=sr), cfg, cuda).half_width
    n = cfg.n_pitch_bins
    L = cs.n_lags(sr, cfg)
    assert pyin_cuda.SHAPES == {"viterbi_fwd": {(1, 40, n, w): len(graph)},
                                "viterbi_back": {(1, 40, n): len(graph)},
                                "trough_obs": {(1, 40, L, n): len(graph)}}
    assert cs.live_graph(cuda, sr, financial, cfg) is not None
    assert cs.same_tiles(graph, cs.eager_tiles(cuda, y, sr, financial, cfg))


@pytest.mark.cuda
def test_live_graph_sessions_interleaved_or_threaded_equal_alone(cuda):
    """Two sessions of one key share the graph's static tensors: fed a
    tile each in turn, or from two threads at once, each gives bitwise
    the tiles it gives alone."""
    from aegis_tpu_torch.tools.signal_gen import generate_bench_track

    cs = _chip_smoke()
    ys = [generate_bench_track(10.0, sr=44100, seed=s) for s in (42, 43)]
    alone = [cs.graph_session(cuda, y, 44100) for y in ys]
    assert not cs.same_tiles(alone[0], alone[1])
    for got in (cs.interleaved_sessions(cuda, ys, 44100),
                cs.threaded_sessions(cuda, ys, 44100)):
        assert all(cs.same_tiles(g, a) for g, a in zip(got, alone))


@pytest.mark.cuda
def test_live_graph_is_captured_once_a_key(cuda):
    """A second session of a key replays the first one's graph; sessions
    at rake 0.3 and 0.9 replay that one graph too, each bitwise the eager
    body at its rake, with rake masks that differ."""
    from aegis_tpu_torch.tools.signal_gen import generate_bench_track

    cs = _chip_smoke()
    y = generate_bench_track(3.0, sr=22050)
    cs.graph_session(cuda, y, 22050)
    first = cs.live_graph(cuda, 22050)
    cs.graph_session(cuda, y, 22050)
    assert first is not None and cs.live_graph(cuda, 22050) is first
    got = cs.rake_sessions(cuda, generate_bench_track(10.0, sr=22050), 22050)
    assert got["bitwise_eager_at"] == "every rake", got
    assert got["one_graph"] and got["rake_masks_differ"], got
    assert cs.live_graph(cuda, 22050) is first


@pytest.mark.cuda
def test_live_graph_captures_beside_rest_work(cuda):
    """A new tile program captured while another thread runs a REST
    analyze and eager tiles: the other thread's work overlaps the capture
    and gives what it gives alone, and the new graph replays bitwise its
    body."""
    got = _chip_smoke().capture_beside_work(cuda)
    assert all(got[k] for k in ("captured", "work_overlapped_capture",
                                "work_equal_alone",
                                "replays_bitwise_body")), got


# ------------------------------------------ the fused program's graphs

@pytest.mark.cuda
@pytest.mark.parametrize("res", [0.1, 0.05])
@pytest.mark.parametrize("seconds", [15, 30, 45, 60, 90, 120])
def test_fused_graph_replays_equal_the_eager_program(cuda, seconds, res):
    """A REST v1 dispatch at each of the benchmark's six length buckets
    (44 100 Hz), at n = 450 and n = 900, replays its key's captured graph:
    the packed buffer bitwise the eager program's on the same samples,
    one launch of each kernel counted a replay at the bucket's shape, and
    the captured decode naming the kernel the launch rule picks."""
    cs = _chip_smoke()
    cfg = PyinConfig(resolution=res)
    kw = cs.fused_args(44100, cfg)
    y = cs.generate_bench_track(float(seconds), sr=44100, seed=seconds)
    eager = cs.fused_eager(cuda, y, **kw)
    cs.reset_counts()
    got = [cs.fused_replayed(cuda, y, **kw) for _ in range(2)]
    graph = cs.fused_graph(cuda, y, **kw)
    n = cfg.n_pitch_bins
    w = cs.tables_from_numpy(kw["audio"], cfg, cuda).half_width
    T = kw["audio"].n_frames(len(cs.pad_to_bucket(y)))
    L = cs.n_lags(44100, cfg)
    assert pyin_cuda.SHAPES == {"viterbi_fwd": {(1, T, n, w): 2},
                                "viterbi_back": {(1, T, n): 2},
                                "trough_obs": {(1, T, L, n): 2}}
    assert all(cs.same_bytes(g, eager) for g in got)
    kernel = "viterbi_fwd_wide_kernel" if n > 512 else "viterbi_fwd_kernel"
    assert [a["kernel"] for a in graph.captured.decodes] == [kernel]
    assert graph.bucket == len(cs.pad_to_bucket(y))


@pytest.mark.cuda
@pytest.mark.parametrize("transport,fetch_mel,financial", [
    ("int8", True, False), ("int8", False, False), ("int16", True, False),
    ("int16", False, False), ("int8", False, True)])
def test_fused_graph_replays_equal_at_each_transport(cuda, transport,
                                                     fetch_mel, financial):
    """The int8 and int16 transports with and without the mel rows, and
    the folder's financial key, at 30 s @ 22 050 Hz: replays bitwise the
    eager program, one graph for the key."""
    cs = _chip_smoke()
    kw = cs.fused_args(22050, transport=transport, fetch_mel=fetch_mel,
                       financial=financial)
    y = cs.generate_bench_track(30.0, sr=22050, seed=7)
    eager = cs.fused_eager(cuda, y, **kw)
    first = cs.fused_replayed(cuda, y, **kw)
    graph = cs.fused_graph(cuda, y, **kw)
    assert cs.same_bytes(first, eager)
    assert cs.same_bytes(cs.fused_replayed(cuda, y, **kw), eager)
    assert graph is not None and cs.fused_graph(cuda, y, **kw) is graph


@pytest.mark.cuda
def test_fused_graph_is_captured_once_a_key(cuda):
    """A second dispatch, and dispatches at rake 0.3 and 0.9, replay the
    first graph, each bitwise the eager program at its rake, with rake
    masks that differ as the eager ones do."""
    from aegis_tpu_torch.core.analyze import _V1_ROWS

    cs = _chip_smoke()
    kw = cs.fused_args(22050)
    y, _ = cs.generate_test_track(sr=22050)
    cs.fused_replayed(cuda, y, **kw)
    first = cs.fused_graph(cuda, y, **kw)
    col = kw["audio"].n_mels + _V1_ROWS.index("rake_mask")
    masks = {}
    for rake in (0.6, 0.3, 0.9):
        got = cs.fused_replayed(cuda, y, rake, **kw)
        want = cs.fused_eager(cuda, y, rake, **kw)
        assert cs.same_bytes(got, want), rake
        assert cs.fused_graph(cuda, y, **kw) is first
        masks[rake] = got[:, col]
    assert (masks[0.3] != masks[0.9]).any()


@pytest.mark.cuda
def test_fused_graph_dispatch_ahead_keeps_each_tracks_rows(cuda):
    """Six tracks dispatched ahead as the folder does, two of them of one
    bucket back to back, then all fetched: each track's rows are its own
    eager rows."""
    from aegis_tpu_torch.core.analyze import _unpack, _V1_ROWS

    cs = _chip_smoke()
    kw = cs.fused_args(44100, fetch_mel=False)
    ys = [cs.generate_bench_track(float(s), sr=44100, seed=100 + i)
          for i, s in enumerate((15, 30, 30, 45, 60, 15))]
    assert len(cs.pad_to_bucket(ys[1])) == len(cs.pad_to_bucket(ys[2]))
    got = cs.fused_ahead(cuda, ys, **kw)
    for y, rows in zip(ys, got):
        T = kw["audio"].n_frames(len(y))
        want = _unpack(cs.fused_eager(cuda, y, **kw)[:T], _V1_ROWS, 0)
        assert set(rows) == set(want)
        assert all(rows[k].tobytes() == want[k].tobytes() for k in rows)
    assert got[1]["f0"].tobytes() != got[2]["f0"].tobytes()


@pytest.mark.cuda
def test_fused_graph_eviction_frees_the_graph_and_recaptures_it(cuda,
                                                                monkeypatch):
    """With a cache of two graphs, a third key evicts the first: its graph
    is freed, and its next dispatch captures it anew with the same rows,
    which its replays give too."""
    import gc
    import weakref

    from aegis_tpu_torch.core import analyze

    cs = _chip_smoke()
    dev = torch.device("cuda", torch.cuda.current_device())
    monkeypatch.setattr(analyze, "FUSED_GRAPHS", 2)
    monkeypatch.setitem(analyze._CARDS, dev, analyze.FusedGraphs(dev))
    kw = cs.fused_args(22050)
    ys = [cs.generate_bench_track(float(s), sr=22050, seed=s)
          for s in (5, 10, 20)]
    first = cs.fused_replayed(dev, ys[0], **kw)
    gone = weakref.ref(cs.fused_graph(dev, ys[0], **kw))
    for y in ys[1:]:
        cs.fused_replayed(dev, y, **kw)
    gc.collect()
    assert gone() is None and cs.fused_graph(dev, ys[0], **kw) is None
    assert len(analyze._CARDS[dev]) == 2
    again = cs.fused_replayed(dev, ys[0], **kw)
    assert cs.fused_graph(dev, ys[0], **kw) is not None
    assert cs.same_bytes(again, first)
    assert cs.same_bytes(again, cs.fused_eager(dev, ys[0], **kw))
    assert cs.same_bytes(cs.fused_replayed(dev, ys[0], **kw), first)


# ------------------------------------------------- the polyphonic programs

@pytest.mark.cuda
@pytest.mark.parametrize("sr", [22050, 44100])
def test_peel_on_the_card_equals_the_cpu_and_the_oracle(cuda, sr):
    """The peel is an argmax over near-tied saliences and needs full
    float32 (TF32 off): on the CQT of a chord clip the card's picks agree
    with the CPU's and the NumPy oracle's on >= 0.999 of entries, saliences
    rtol 5e-4 / atol 1e-4 where the picks agree."""
    from aegis_tpu_torch.core import cqt, poly
    from aegis_tpu_torch.core.tables import poly_tables
    from aegis_tpu_torch.ref.poly_ref import peel_voices_ref
    from aegis_tpu_torch.tools.signal_gen import generate_chord_progression

    assert not torch.backends.cuda.matmul.allow_tf32
    scale = sr // 22050
    y = torch.from_numpy(generate_chord_progression(7, sr)[0])
    tb_c = poly_tables(sr, 2048 * scale, 84, 12, 128, torch.device("cpu"))
    tb_g = poly_tables(sr, 2048 * scale, 84, 12, 128, cuda)
    power = cqt.pseudo_cqt_t(y, 512 * scale, tb_c)
    b_c, s_c = poly.peel_voices(power, tb_c.supp, tb_c.sub)
    b_g, s_g = poly.peel_voices(power.to(cuda), tb_g.supp, tb_g.sub)
    b_r, s_r = peel_voices_ref(power.numpy(), tb_c.supp.numpy(),
                               tb_c.sub.numpy())
    b_g, s_g = b_g.cpu().numpy(), s_g.cpu().numpy()
    for b, s in ((b_c.numpy(), s_c.numpy()), (b_r, s_r)):
        assert float(np.mean(b_g == b)) >= 0.999
        same = (b_g == b).all(axis=1)
        np.testing.assert_allclose(s_g[same], s[same], rtol=5e-4, atol=1e-4)
    # the device planes against the oracle's on the card's own voices
    from aegis_tpu_torch.ref.poly_ref import roll_and_confidence_ref
    roll, conf, sal = poly.roll_and_confidence(torch.from_numpy(b_g).to(cuda),
                                               torch.from_numpy(s_g).to(cuda))
    r_r, c_r, a_r = roll_and_confidence_ref(b_g, s_g)
    np.testing.assert_array_equal(roll.cpu().numpy(), r_r)
    np.testing.assert_allclose(conf.cpu().numpy(), c_r, rtol=1e-5)
    np.testing.assert_allclose(sal.cpu().numpy(), a_r, rtol=1e-5)
    mag = torch.sqrt(power)
    assert poly.pack_cqt_f16(mag.to(cuda)).cpu().numpy().tobytes() == \
        poly.pack_cqt_f16(mag).numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, "tiles"])
def test_poly_engine_on_the_card_equals_the_cpu(cuda, mode):
    """The packed program (fused and tiled) on the card against the same
    program on the CPU: bins on >= 0.999 of entries, events equal by note,
    start and end, and neither Viterbi kernel is launched."""
    from aegis_tpu_torch.engine.poly import AegisPolyEngine
    from aegis_tpu_torch.tools.signal_gen import generate_chord_progression

    for k in pyin_cuda.LAUNCHES:
        pyin_cuda.LAUNCHES[k] = 0
    y = generate_chord_progression(3, 22050)[0]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = AegisPolyEngine(sample_rate=22050, device=dev)
        a = eng.analyze(y, turbo_mode=mode)
        out[dev] = (a, eng.extract_events(a))
    (a_g, ev_g), (a_c, ev_c) = out["cuda"], out["cpu"]
    assert (a_g["roll"] == a_c["roll"]).mean() >= 0.9999
    np.testing.assert_allclose(a_g["rms"], a_c["rms"], atol=1e-6)
    np.testing.assert_allclose(a_g["onset_env"], a_c["onset_env"], atol=2e-3)
    assert ev_g and [(e["note"], e["start"], e["end"]) for e in ev_g] == \
        [(e["note"], e["start"], e["end"]) for e in ev_c]
    assert not any(pyin_cuda.LAUNCHES.values())


@pytest.mark.cuda
def test_live_poly_session_on_the_card(cuda):
    from aegis_tpu_torch.engine.realtime import StreamingPolyTranscriber
    from aegis_tpu_torch.tools.signal_gen import generate_chord_progression

    y = generate_chord_progression(7, 22050)[0]
    final = {}
    for dev in ("cuda", "cpu"):
        rt = StreamingPolyTranscriber(sample_rate=22050, device=dev)
        for i in range(0, len(y), 7000):
            rt.feed(y[i:i + 7000])
        assert rt.poll_events() == rt._poll_full()
        assert rt._ref_power.device.type == dev
        final[dev] = rt.finalize()
    assert final["cuda"] and \
        [(e["note"], e["start"], e["end"]) for e in final["cuda"]] == \
        [(e["note"], e["start"], e["end"]) for e in final["cpu"]]


# ------------------------------------------- the auto router's v1 half

@pytest.mark.cuda
def test_kernels_at_the_auto_44100_shape(cuda):
    """The auto router's v1 half runs pYIN at 44 100 Hz on hop 1024: on the
    60 s bench track that is B = 1, T = 2625, w = 101.  Both kernels on the
    observations the router's program computes there, against their plain
    versions: backpointers, final delta and states identical; and one
    AegisAutoEngine.analyze launches each kernel once, at B = 1."""
    from aegis_tpu_torch.config import AudioConfig
    from aegis_tpu_torch.core import pyin as tpyin
    from aegis_tpu_torch.core.analyze import (dequant_transport,
                                              pad_to_bucket, quantize_pcm8)
    from aegis_tpu_torch.core.tables import tables_from_numpy
    from aegis_tpu_torch.engine.auto import AegisAutoEngine
    from aegis_tpu_torch.tools.signal_gen import generate_bench_track

    y = generate_bench_track(60.0, sr=44100)
    tables = tables_from_numpy(AudioConfig(sample_rate=44100,
                                           hop_length=1024), CFG, cuda)
    y8, s8 = quantize_pcm8(pad_to_bucket(y))
    yd = dequant_transport(torch.from_numpy(y8).to(cuda),
                           torch.from_numpy(s8).to(cuda))
    frames = tpyin.extract_pyin_frames(yd, 1024, CFG)
    obs, vprob = tpyin.frame_observations(frames, 44100, CFG, tables)
    lo_v, lo_u = tpyin.decode_inputs(obs[None], vprob[None])
    assert lo_v.shape[:2] == (1, 2625) and tables.half_width == 101
    n, w = N, tables.half_width
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(
        lo_v, lo_u, tables.band, n, w, LOG_STAY, LOG_SWITCH, tables.band_tab)
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    p_v, p_u, p_last = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(tables.band, n, w), LOG_STAY,
        LOG_SWITCH)
    assert torch.equal(psi_v, p_v) and torch.equal(psi_u, p_u)
    assert torch.equal(d_last, p_last)
    assert torch.equal(states, pyin_cuda.viterbi_back_plain(p_last, p_v, p_u))

    eng = AegisAutoEngine(sample_rate=44100, device=cuda)
    for counts in (pyin_cuda.LAUNCHES, pyin_cuda.SEQUENCES):
        for k in counts:
            counts[k] = 0
    a = eng.analyze(y)
    torch.cuda.synchronize()
    assert pyin_cuda.LAUNCHES == {"viterbi_fwd": 1, "viterbi_back": 1,
                                  "trough_obs": 1}
    assert pyin_cuda.LAST_BATCH == {"viterbi_fwd": 1, "viterbi_back": 1,
                                    "trough_obs": 1}
    assert a["v1"]["f0"].shape == (1 + len(y) // 1024,)


# ------------------------------- HPSS, the ADSR synth and the effect chain

@pytest.mark.cuda
@pytest.mark.parametrize("slabs", [False, True])
def test_hpss_on_the_card_equals_the_cpu(cuda, slabs, monkeypatch):
    """HPSS on the card against the same wrapper on the CPU, within 1e-4
    (max abs), one program and in slabs."""
    from aegis_tpu_torch.core import hpss as H
    from aegis_tpu_torch.tools.signal_gen import generate_bench_track

    y = generate_bench_track(8.0, sr=22050)
    if slabs:
        monkeypatch.setattr(H, "_SLAB_SAMPLES", 1 << 16)
    for a, b in zip(H.hpss(y, device=cuda), H.hpss(y, device="cpu")):
        assert a.shape == y.shape and np.abs(a - b).max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [22050, 44100])
def test_render_notes_on_the_card_equals_the_cpu(cuda, sr):
    """The batched render and mixdown on the card within 1e-5 of the CPU,
    with equal integer segment lengths."""
    from aegis_tpu_torch.synth import adsr

    rng = np.random.default_rng(sr)
    N, max_len, total = 40, 1 << 15, 1 << 20
    args = (rng.uniform(80, 3000, N).astype(np.float32),
            rng.integers(0, total, N).astype(np.int32),
            rng.integers(100, max_len - 1, N).astype(np.int32),
            rng.uniform(0, 127, N).astype(np.float32),
            rng.uniform(1, 400, N).astype(np.float32),
            rng.uniform(1, 900, N).astype(np.float32),
            rng.uniform(0.05, 1, N).astype(np.float32),
            rng.uniform(5, 900, N).astype(np.float32),
            rng.integers(0, 4, N).astype(np.int32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in args]
        out[dev.type] = (adsr.render_notes(*t, sr, max_len, total).cpu(),
                         [s.cpu() for s in adsr.segment_lengths(
                             t[4], t[5], t[7], sr)])
    assert (out["cuda"][0] - out["cpu"][0]).abs().max() <= 1e-5
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["light_overdrive", "ambient",
                                    "chorus_clean", "full_fx"])
def test_effect_chain_on_the_card_equals_the_cpu(cuda, preset):
    """Every effect on the card within 1e-4 of the CPU; the chorus picks the
    same source samples on both."""
    from aegis_tpu_torch.synth.effects import (EFFECT_PRESETS,
                                               apply_effect_chain)
    from aegis_tpu_torch.synth.adsr import synthesize_note_arrays

    notes = [{"note": 40 + (7 * k) % 36, "start": 0.3 * k,
              "end": 0.3 * k + 0.5, "velocity": 70 + k} for k in range(30)]
    x = synthesize_note_arrays(notes, 44100, device="cpu")
    a = apply_effect_chain(x, EFFECT_PRESETS[preset], 44100, device=cuda)
    b = apply_effect_chain(x, EFFECT_PRESETS[preset], 44100, device="cpu")
    assert a.shape == x.shape and np.abs(a - b).max() <= 1e-4


def _train_bank(dev, n=48, seed=2):
    from aegis_tpu_torch.models.data import make_clips
    d = make_clips(n, 8192, seed=seed)
    return [torch.from_numpy(d[k]).to(dev)
            for k in ("tracks", "scale", "f0_hz", "voiced", "label_w")]


def _chip_smoke():
    """chip_smoke.py, which holds the training checks that its train phase
    runs at full size and these tests at a small one."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
def test_train_steps_on_the_card_equal_the_cpu(cuda):
    """Eight AdamW steps of the full-width net on the same crops, from the
    same parameters, on the card and on the CPU: parameters within 1e-5,
    each loss within 1e-5 of the CPU's, relative."""
    from aegis_tpu_torch.models import pitchnet as tpn

    param_err, loss_err = _chip_smoke().card_vs_cpu_steps(
        cuda, _train_bank("cpu"), 64, tpn.lr_schedule(20), seed=3)
    assert param_err <= 1e-5 and loss_err <= 1e-5, (param_err, loss_err)


@pytest.mark.cuda
def test_training_on_the_card_is_deterministic(cuda):
    """Two 30-step runs from one seed (sampling on the card's generator)
    give bitwise-equal parameters; another seed gives other ones."""
    from aegis_tpu_torch.models import pitchnet as tpn

    bank = _train_bank(cuda)
    lr = tpn.lr_schedule(30)

    def run(seed):
        net = _chip_smoke().train_from_seed(cuda, bank, 64, 30, seed, lr)[0]
        return [p.detach().cpu() for p in net.parameters()]

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.cuda
def test_validate_on_the_card(cuda):
    """The quick F1 gate on the card passes with every oracle F1 at 1.0."""
    from aegis_tpu_torch.tools.validate_device import validate

    res = validate(include_bench=False, quiet=True, device=cuda)
    assert res["pass"], res
    assert all(row.get("v1_f1", 1.0) == 1.0
               and row.get("financial_f1", 1.0) == 1.0
               for row in res["clips"].values())


@pytest.mark.cuda
def test_tuning_center_on_the_card_equals_the_facade(cuda):
    """One Tuning Center rerun on the card through chip_smoke.py's
    streamlit stand-in (its phase 28 runs the same at full size): the MIDI
    and the events the app records equal the facade's on the same upload,
    with one launch of each kernel."""
    import io

    from aegis_tpu_torch.apps import tuning_center
    from aegis_tpu_torch.engine.engine import AegisEngine
    from aegis_tpu_torch.tools.signal_gen import generate_test_track

    cs = _chip_smoke()
    wav = cs.wav_bytes(generate_test_track(sr=44100)[0], 44100)
    st = cs.StreamlitStandIn({"Audio file": cs.Upload(wav, "ks.wav")})
    log, counts, _ = cs.run_counted(
        lambda: st.run(tuning_center.main, device=cuda))
    assert counts == {"viterbi_fwd": 1, "viterbi_back": 1, "trough_obs": 1}
    eng = AegisEngine(sample_rate=44100, device=cuda)
    raw = eng.audio_to_midi(wav, None, start_time=0.0, end_time=None,
                            turbo_mode=False, rake_sensitivity=0.6,
                            pitch_backend="pyin")
    buf = io.BytesIO()
    events = eng.extract_events(raw, buf, **cs.TC_EXTRACT)
    assert cs.midi_of(log) == buf.getvalue()
    assert cs.outputs(log, "dataframe")[0][0] == cs.tc_rows(events)


@pytest.mark.cuda
def test_profile_kernels_reads_what_the_event_tree_reads(cuda, monkeypatch):
    """chip_smoke.py's profile_kernels reads the profiler's raw events: the
    same kernels, launch counts and device time as the FunctionEvent tree
    (``prof.events()``) of the same session, read with the same filter."""
    from aegis_tpu_torch.engine.engine import AegisEngine
    from aegis_tpu_torch.tools.signal_gen import generate_test_track

    cs = _chip_smoke()
    sessions = []
    real = torch.profiler.profile

    class Kept(real):
        def __enter__(self):
            sessions.append(self)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "profile", Kept)
    eng = AegisEngine(sample_rate=44100, device=cuda)
    y = generate_test_track(sr=44100)[0]
    kernels, _ = cs.profile_kernels(lambda: eng.audio_to_midi(y))
    events = sessions[0].events()
    dev = torch.autograd.DeviceType.CUDA
    mark = next(e for e in events if e.name == "aegis.profiled_runs"
                and e.device_type != dev)
    tree: dict = {}
    for e in events:
        if (e.device_type == dev and not e.is_user_annotation
                and e.time_range.start >= mark.time_range.start):
            k = tree.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    assert sorted(kernels) == sorted(tree) and len(tree) > 10
    for name, (us, n) in tree.items():
        assert kernels[name][1] == n, name
        assert abs(kernels[name][0] - us) <= 1e-3, name
    assert any("viterbi" in name for name in kernels)


@pytest.mark.cuda
def test_nccl_world_of_one_equals_the_one_process_program(cuda, tmp_path):
    """A world of one NCCL rank in this process: the tiled batch on a (1, 1)
    mesh is bit for bit the call with no mesh, with the same launches."""
    import torch.distributed as dist

    from aegis_tpu_torch.config import AudioConfig, TurboConfig
    from aegis_tpu_torch.engine import turbo
    from aegis_tpu_torch.utils import mesh as mesh_lib

    sr = 22050
    t = np.arange(sr) / sr
    ys = np.stack([0.4 * np.sin(2 * np.pi * f * t) for f in (196.0, 261.63)]
                  ).astype(np.float32)
    audio, tc = AudioConfig(sample_rate=sr), TurboConfig(tile_frames=16,
                                                         halo_frames=8)
    before = dict(pyin_cuda.LAUNCHES)
    ref = turbo.run_analyze_batch(ys, audio, CFG, turbo=tc, financial=True,
                                  device=cuda)
    one = {k: v - before[k] for k, v in pyin_cuda.LAUNCHES.items()}
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.Mesh(1, 1, device="cuda")
        assert mesh.backend == "nccl" and mesh.staging == "none"
        before = dict(pyin_cuda.LAUNCHES)
        got = turbo.run_analyze_batch(ys, audio, CFG, turbo=tc,
                                      financial=True, device="cuda",
                                      mesh=mesh)
        assert {k: v - before[k] for k, v in pyin_cuda.LAUNCHES.items()} \
            == one == {"viterbi_fwd": 1, "viterbi_back": 1, "trough_obs": 1}
        assert mesh_lib.results_equal(got, ref)
    finally:
        dist.destroy_process_group()
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="one card a rank"):
        mesh_lib.spmd(turbo.run_analyze_batch, 1, n + 1, ys, audio, CFG,
                      device="cuda")


@pytest.mark.cuda
def test_gloo_on_the_card_stages_through_the_host(cuda, tmp_path):
    """Gloo ranks that share a card: every collective copies to the host and
    back, and hands the card's tensor back on the card, unchanged."""
    import torch.distributed as dist

    from aegis_tpu_torch.utils import mesh as mesh_lib

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.Mesh(1, 1, device="cuda", backend="gloo")
        assert mesh.staging == "host"
        x = torch.arange(12.0, device=cuda).reshape(3, 4)
        for got in (mesh.gather_world(x)[0], mesh.pmax_time(x),
                    mesh.psum_world(x), mesh.all_gather_time(x, dim=1)):
            assert got.device == x.device and torch.equal(got, x)
        assert mesh.halo(x[:, :2], x[:, 2:]) == (None, None)
    finally:
        dist.destroy_process_group()
