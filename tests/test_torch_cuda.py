"""The CUDA Viterbi kernels vs their plain PyTorch versions, and the
polyphonic programs vs the CPU, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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
    with pytest.raises(ValueError, match="states"):
        wide = torch.zeros((1, 8, 600), device=cuda)
        pyin_cuda.viterbi_fwd(wide, lo_u, band, 600, 51, 0.0, 0.0)
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
            "viterbi_fwd": n, "viterbi_back": n}
        sessions[dev] = (np.concatenate(rt._rows), events)
    (rows_g, ev_g), (rows_c, ev_c) = sessions["cuda"], sessions["cpu"]
    assert ev_g and [(e["note"], e["start"], e["end"]) for e in ev_g] == \
        [(e["note"], e["start"], e["end"]) for e in ev_c]
    for i, k in enumerate(rt._rows_spec):
        if k in ("f0", "voiced_flag", "rake_mask", "mute_mask"):
            same = np.isclose(rows_g[:, i], rows_c[:, i], rtol=1e-6,
                              equal_nan=True)
            assert same.mean() >= 0.99, (k, same.mean())


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
    assert pyin_cuda.LAUNCHES == {"viterbi_fwd": 1, "viterbi_back": 1}
    assert pyin_cuda.LAST_BATCH == {"viterbi_fwd": 1, "viterbi_back": 1}
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
