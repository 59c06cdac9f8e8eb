"""aegis_tpu_torch pYIN stages and Viterbi decode vs the JAX package's.

Every stage gets the same input on both sides (numpy, seeded), so each
comparison isolates one stage.  Tolerances follow tests/test_pyin_parity.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import pyin as jpyin
from aegis_tpu.core import pyin_pallas as vp
from aegis_tpu.ref.pyin_ref import local_transition
from aegis_tpu_torch.config import AudioConfig as TAudioConfig
from aegis_tpu_torch.config import PyinConfig as TPyinConfig
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import (LOG_FLOOR, band_class_table,
                                         expand_class_table,
                                         log_transition_band, row_classes,
                                         tables_from_numpy)
from aegis_tpu_torch.tools.signal_gen import wandering_pitch_obs

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

CFG = PyinConfig()
TCFG = TPyinConfig()    # the port is handed its own class
N = CFG.n_pitch_bins
SR = 22050
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def yin_22k(two_tone_22k):
    y, sr = two_tone_22k
    frames = np.asarray(jpyin.extract_pyin_frames(jnp.asarray(y), 512, CFG))
    yin = np.asarray(jpyin.cmndf_frames(jnp.asarray(frames), CFG.win_length,
                                        CFG.min_period(sr), CFG.max_period(sr)))
    return frames, yin


def _wandering_obs(T, seed, center, step, spread, jumps):
    return wandering_pitch_obs(T, N, seed, center, step, spread, jumps)


# the two synthetic cases of tests/test_pyin_parity.py, at their T
SYNTH = {
    "w101": (CFG.transition_width(22050, 512),
             _wandering_obs(40, 11, 200, 8, (-2, -1, 0, 1, 2), True)),
    "w51": (CFG.transition_width(44100, 512),
            _wandering_obs(32, 21, 150, 4, (0,), False)),
}


def _jax_scan(obs, vprob, width):
    log_local = jnp.asarray(np.log(local_transition(N, width) + 1e-30),
                            jnp.float32)
    return np.asarray(jpyin.viterbi_decode(jnp.asarray(obs), jnp.asarray(vprob),
                                           log_local, CFG.switch_prob))


# --------------------------------------------------------------- the stages

def test_frames_match_jax(two_tone_22k, yin_22k):
    y, _ = two_tone_22k
    got = tpyin.extract_pyin_frames(_t(y), 512, TCFG).numpy()
    np.testing.assert_array_equal(got, yin_22k[0])


def test_cmndf_matches_jax(yin_22k):
    frames, yin = yin_22k
    got = tpyin.cmndf_frames(_t(frames), TCFG.win_length, TCFG.min_period(SR),
                             TCFG.max_period(SR)).numpy()
    assert got.shape == yin.shape
    np.testing.assert_allclose(got, yin, atol=1e-4)


def test_shifts_and_trough_mask_match_jax(yin_22k):
    _, yin = yin_22k
    np.testing.assert_allclose(tpyin.parabolic_shifts(_t(yin)).numpy(),
                               np.asarray(jpyin.parabolic_shifts(yin)),
                               atol=1e-6)
    np.testing.assert_array_equal(tpyin.trough_mask(_t(yin)).numpy(),
                                  np.asarray(jpyin.trough_mask(yin)))


def test_trough_probabilities_match_jax(yin_22k):
    _, yin = yin_22k
    mask = np.asarray(jpyin.trough_mask(yin))
    ref = np.asarray(jpyin.trough_probabilities(yin, mask, CFG))
    tables = tables_from_numpy(TAudioConfig(sample_rate=SR), TCFG, CPU)
    got = tpyin.trough_probabilities(_t(yin), _t(mask), TCFG, tables).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _trough_inputs(yin):
    mask = np.asarray(jpyin.trough_mask(yin))
    probs = np.asarray(jpyin.trough_probabilities(yin, mask, CFG))
    shifts = np.asarray(jpyin.parabolic_shifts(yin))
    return probs, shifts


def test_observations_match_jax(yin_22k):
    probs, shifts = _trough_inputs(yin_22k[1])
    ref_obs, ref_vp = (np.asarray(a) for a in jpyin.observations(
        probs, shifts, SR, CFG.min_period(SR), CFG))
    obs, vprob = tpyin.observations(_t(probs), _t(shifts), SR,
                                    TCFG.min_period(SR), TCFG)
    np.testing.assert_allclose(obs.numpy(), ref_obs, atol=1e-6)
    np.testing.assert_allclose(vprob.numpy(), ref_vp, atol=1e-6)


def test_observations_deterministic(yin_22k):
    probs, shifts = _trough_inputs(yin_22k[1])
    runs = [tpyin.observations(_t(probs), _t(shifts), SR, TCFG.min_period(SR),
                               TCFG) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ Viterbi

@pytest.mark.parametrize("case", sorted(SYNTH))
def test_viterbi_plain_equals_jax_scan(case):
    width, (obs, vprob) = SYNTH[case]
    ref = _jax_scan(obs, vprob, width)
    log_local = _t(np.log(local_transition(N, width) + 1e-30).astype(np.float32))
    got = tpyin.viterbi_decode(_t(obs), _t(vprob), log_local,
                               TCFG.switch_prob).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", sorted(SYNTH))
def test_viterbi_plain_vs_jax_pallas_interpret(case):
    width, (obs, vprob) = SYNTH[case]
    trans = local_transition(N, width)
    band = jnp.asarray(vp.build_banded_log_transition(trans, width))
    pallas = np.asarray(vp.viterbi_decode_pallas(
        jnp.log(jnp.asarray(obs) + 1e-30),
        jnp.log((1.0 - jnp.asarray(vprob)) / N + 1e-30),
        band, N, width,
        float(np.log1p(-CFG.switch_prob)), float(np.log(CFG.switch_prob)),
        interpret=True))
    got = tpyin.viterbi_decode(
        _t(obs), _t(vprob), _t(np.log(trans + 1e-30).astype(np.float32)),
        TCFG.switch_prob).numpy()
    assert (got == pallas).mean() > 0.99


@pytest.mark.parametrize("width", [51, 101, 150])
def test_band_table_is_the_dense_matrix(width):
    dense = np.log(local_transition(N, width) + 1e-30).astype(np.float32)
    band = _t(log_transition_band(N, width))
    np.testing.assert_array_equal(
        pyin_cuda.dense_from_band(band, N, width).numpy(), dense)


# (n, w): both rates of the main path, 48 kHz's width, one n < 2w + 1,
# and the finer pitch grids of resolution 0.05 / 0.04 / 0.02
@pytest.mark.parametrize("n,width", [
    (N, 101), (N, 51), (N, TCFG.transition_width(48000, 512)), (150, 101),
    (900, 101), (1125, 126), (2250, 501)])
def test_class_table_expands_to_the_band(n, width):
    """The band without its repetitions: (w+1, w+1) classes by offsets (n
    rows where n < 2w + 1), read out of log_transition_band and expanding
    back to it bit for bit; a band that is no such function raises."""
    band = log_transition_band(n, width)
    tab = band_class_table(band, n, width)
    assert tab.dtype == np.float32
    assert tab.shape == ((n if n < 2 * width + 1 else width + 1), width + 1)
    back = expand_class_table(tab, n, width)
    np.testing.assert_array_equal(back.view(np.uint32), band.view(np.uint32))
    # it is the JAX package's matrix, entry for entry
    dense = np.log(local_transition(n, width) + 1e-30).astype(np.float32)
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    d = np.abs(i - j)
    inb = d <= width
    got = np.where(inb, tab[row_classes(n, width)[i], np.minimum(d, width)],
                   LOG_FLOOR)
    np.testing.assert_array_equal(got.view(np.uint32), dense.view(np.uint32))
    broken = band.copy()
    broken[n // 2, width + 1] += 1.0   # one pair no longer like its mirror
    with pytest.raises(ValueError, match="class table"):
        band_class_table(broken, n, width)


def _forward_as_the_kernel(lo_v, lo_u, tab, n, w, log_stay, log_switch, D, S):
    """The CUDA forward kernel's candidate sets in NumPy (csrc/viterbi.cu):
    per destination tile of D states the sources of its S chunks, scored
    from the symmetric expansion of the class table (log_floor beyond the
    band), plus the global first argmax of delta + log_floor where that
    lies outside the destination's band."""
    f32 = np.float32
    floor, ls, lw = f32(LOG_FLOOR), f32(log_stay), f32(log_switch)
    T = lo_v.shape[0]
    cls = row_classes(n, w)
    span = 4 * S * ((2 * w + D + 4 * S - 1) // (4 * S))   # grouped compares
    rs = (span + D - 1 + 3) // 4 * 4
    x = np.abs(np.arange(rs) - (w + D - 1))
    etab = np.where(x <= w, tab[:, np.minimum(x, w)], floor).astype(f32)
    init = f32(np.log(1.0 / (2 * n)))
    dv = (init + lo_v[0]).astype(f32)
    du = np.full(n, init + lo_u[0], f32)
    psi_v = np.zeros((T, n), np.int32)
    psi_u = np.zeros((T, n), np.int32)

    def better(m, b, m2, b2):
        return (m2, b2) if m2 > m or (m2 == m and b2 < b) else (m, b)

    for t in range(1, T):
        fv, fu = dv + floor, du + floor
        gvi, gui = int(np.argmax(fv)), int(np.argmax(fu))
        new_v, new_u = np.empty(n, f32), np.empty(n, f32)
        for j in range(n):
            j0 = j // D * D
            lo = j0 - w
            i = np.arange(max(lo, 0), min(lo + span - 1, n - 1) + 1)
            lt = etab[cls[i], (i - lo) + (D - 1) - (j - j0)]
            sv, su = dv[i] + lt, du[i] + lt
            mv, bv = sv.max(), int(i[np.argmax(sv)])
            mu, bu = su.max(), int(i[np.argmax(su)])
            if abs(gvi - j) > w:
                mv, bv = better(mv, bv, fv[gvi], gvi)
            if abs(gui - j) > w:
                mu, bu = better(mu, bu, fu[gui], gui)
            stay, sw = mv + ls, mu + lw
            new_v[j] = (stay if stay >= sw else sw) + lo_v[t, j]
            psi_v[t, j] = bv if stay >= sw else bu + n
            sw2, st2 = mv + lw, mu + ls
            new_u[j] = (sw2 if sw2 >= st2 else st2) + lo_u[t]
            psi_u[t, j] = bv if sw2 >= st2 else bu + n
        dv, du = new_v, new_u
    return psi_v, psi_u, np.stack([dv, du])


# (n, w, T, D, S): the shipped tile at both rates, the widest and the
# narrowest tile, n < 2w + 1, a band wider than a third of the states
@pytest.mark.parametrize("n,width,T,D,S", [
    (N, 101, 16, 8, 8), (N, 51, 16, 8, 8), (N, 51, 10, 8, 16),
    (N, 101, 10, 1, 1), (150, 101, 12, 8, 8), (N, 150, 10, 4, 4),
    (37, 5, 15, 8, 4)])
def test_forward_kernel_candidates_equal_plain(n, width, T, D, S):
    """What the forward kernel compares gives the dense scan's backpointers
    and final delta exactly: the class table in place of the band, the
    tile's source range, and one global maximum in place of the out-of-band
    prefix / suffix maxima."""
    obs, vprob = wandering_pitch_obs(T, n, 7 + n + width, min(200, n // 2), 8,
                                     (-2, -1, 0, 1, 2), True)
    lo_v = np.log(obs + 1e-30).astype(np.float32)
    lo_u = np.log((1.0 - vprob) / n + 1e-30).astype(np.float32)
    band = log_transition_band(n, width)
    ls = float(np.log1p(-TCFG.switch_prob))
    lw = float(np.log(TCFG.switch_prob))
    got = _forward_as_the_kernel(lo_v, lo_u, band_class_table(band, n, width),
                                 n, width, ls, lw, D, S)
    ref = pyin_cuda.viterbi_fwd_plain(
        _t(lo_v)[None], _t(lo_u)[None],
        pyin_cuda.dense_from_band(_t(band), n, width), ls, lw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r[0].numpy())


# (B, T, n, chunk): T - 1 a multiple of the chunk and not, one chunk only,
# T = 1 and T = 2, the shipped chunk at the real state count
@pytest.mark.parametrize("B,T,n,chunk", [
    (1, 9, 7, 4), (1, 10, 7, 4), (3, 13, 11, 4), (2, 3, 5, 8), (1, 1, 7, 4),
    (2, 2, 7, 4), (1, 130, N, pyin_cuda.BACK_CHUNK),
    (2, 129, N, pyin_cuda.BACK_CHUNK)])
def test_chunked_backtrace_equals_plain(B, T, n, chunk):
    """The backtrace kernels' algorithm (chunk maps, hop, re-walk) in plain
    PyTorch against the frame-by-frame walk, on seeded backpointers."""
    rng = np.random.default_rng(1000 * B + T)
    psi_v = _t(rng.integers(0, 2 * n, (B, T, n)).astype(np.int32))
    psi_u = _t(rng.integers(0, 2 * n, (B, T, n)).astype(np.int32))
    d_last = _t(rng.standard_normal((B, 2, n)).astype(np.float32))
    d_last[:, 1, n // 2] = d_last[:, 0, 1] = d_last.max() + 1.0   # a tie
    ref = pyin_cuda.viterbi_back_plain(d_last, psi_v, psi_u)
    got = pyin_cuda.viterbi_back_chunked_plain(d_last, psi_v, psi_u, chunk)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert int(got[0, T - 1]) == 1   # the first of the two equal maxima


def test_decode_states_wide_band_equals_jax_scan():
    """w = 150 > 127: a band the TPU kernel could not take (its Hankel rows
    stop at 256); the port's decode takes any w."""
    width = 150
    obs, vprob = _wandering_obs(48, 5, 220, 20, (-1, 0, 1), True)
    with pytest.raises(ValueError):
        vp.build_banded_log_transition(local_transition(N, width), width)
    ref = _jax_scan(obs, vprob, width)
    tables = tables_from_numpy(TAudioConfig(sample_rate=SR), TCFG, CPU)
    band = log_transition_band(N, width)
    wide = dataclasses.replace(tables, band=_t(band), half_width=width,
                               band_tab=_t(band_class_table(band, N, width)))
    got = tpyin._decode_states(_t(obs)[None], _t(vprob)[None], wide,
                               TCFG)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_batched_plain_decode_equals_per_sequence():
    width, (obs_a, vp_a) = SYNTH["w51"]
    obs_b, vp_b = _wandering_obs(32, 99, 300, 6, (0, 1), True)
    band = _t(log_transition_band(N, width))
    lo_v = torch.log(_t(np.stack([obs_a, obs_b])) + 1e-30)
    lo_u = torch.log((1.0 - _t(np.stack([vp_a, vp_b]))) / N + 1e-30)
    args = (band, N, width, float(np.log1p(-CFG.switch_prob)),
            float(np.log(CFG.switch_prob)))
    both = pyin_cuda.viterbi_decode_cuda(lo_v, lo_u, *args)
    for b in range(2):
        one = pyin_cuda.viterbi_decode_cuda(lo_v[b:b + 1], lo_u[b:b + 1], *args)
        assert torch.equal(both[b], one[0])


# ------------------------------------------------------- the card by default

def _device_functions():
    """Every public function and class of the port that takes ``device``."""
    import importlib
    import inspect
    import pkgutil
    import aegis_tpu_torch
    found = {}
    for mod in pkgutil.walk_packages(aegis_tpu_torch.__path__,
                                     "aegis_tpu_torch."):
        m = importlib.import_module(mod.name)
        for name, obj in vars(m).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.name:
                continue
            if inspect.isfunction(obj) or inspect.isclass(obj):
                p = inspect.signature(obj).parameters.get("device")
                if p is not None and p.kind is not p.POSITIONAL_ONLY:
                    found[f"{mod.name}.{name}"] = (obj, p)
    return found


def test_every_device_argument_defaults_to_the_card():
    found = _device_functions()
    expected = {"core.pyin.pyin", "core.analyze.run_analyze",
                "core.analyze.dispatch_analyze",
                "engine.turbo.run_analyze_turbo",
                "engine.turbo.run_analyze_batch",
                "engine.turbo.run_analyze_streamed",
                "engine.engine.AegisEngine",
                "engine.financial.AegisFinancialEngine",
                "engine.folder.transcribe_folder",
                "engine.realtime.StreamingTranscriber",
                "engine.poly.dispatch_analyze_poly",
                "engine.poly.AegisPolyEngine",
                "engine.turbo.run_analyze_poly_turbo",
                "engine.realtime.StreamingPolyTranscriber",
                "engine.auto.AegisAutoEngine",
                "engine.auto.dispatch_analyze_auto",
                "models.pitchnet.run_analyze_neural",
                "models.pitchnet.dispatch_analyze_neural",
                "models.pitchnet.run_analyze_neural_streamed",
                "models.pitchnet.default_params",
                "core.hpss.hpss", "core.hpss.hpss_program",
                "synth.stems.separate_stems", "synth.stems.separate_hpss",
                "synth.adsr.synthesize_note_arrays",
                "synth.adsr.midi_to_wav_adsr",
                "synth.adsr.synthesize_midi_adsr",
                "synth.fluidsynth.synthesize_midi",
                "synth.effects.apply_effect_chain",
                "verify.similarity.audio_similarity",
                "verify.similarity.note_slice_similarity",
                "verify.per_note.optimize_all_notes",
                "verify.per_note.synthesize_with_per_note_params",
                "verify.technique.verify_technique_by_audio_matching",
                "viz.piano_roll.render_piano_roll",
                "serve.server.AegisServer", "serve.server.main",
                "models.pitchnet.init_params",
                "models.pitchnet.init_train_state", "models.train.evaluate",
                "models.train.train", "tools.validate_device.validate",
                "tools.benchmark.run_benchmark",
                "tools.inharmonic_sweep.sweep",
                "apps.tuning_center.main", "apps.tuner_pro.main",
                "apps.live_monitor.main", "apps.live_monitor.make_transcriber",
                "apps.financial_batch.main", "apps.financial_realtime.main",
                "apps.stem_lab.main", "apps.midi_sandbox.main",
                "models.pitchnet.run_analyze_neural_batch",
                "models.pitchnet.train_on_batches", "utils.mesh.Mesh",
                "utils.mesh.default_mesh", "utils.mesh.spmd",
                "utils.mesh.run_spmd", "__main__.warmup",
                "verify.per_note.optimize_single_note"}
    assert expected <= {k.replace("aegis_tpu_torch.", "") for k in found}
    for name, (_, p) in found.items():
        if p.default is not p.empty:   # a required device names itself
            assert p.default == "cuda", name


@pytest.mark.parametrize("entry", [
    "pyin", "run_analyze", "dispatch_analyze", "run_analyze_turbo",
    "run_analyze_batch", "run_analyze_streamed", "AegisEngine",
    "AegisFinancialEngine", "transcribe_folder", "StreamingTranscriber",
    "resolve_device", "dispatch_analyze_poly", "AegisPolyEngine",
    "run_analyze_poly_turbo", "StreamingPolyTranscriber",
    "transcribe_folder_poly", "AegisAutoEngine", "dispatch_analyze_auto",
    "transcribe_folder_auto", "run_analyze_neural", "dispatch_analyze_neural",
    "run_analyze_neural_streamed", "transcribe_folder_neural",
    "hpss", "hpss_program", "separate_stems", "separate_hpss",
    "separate_stems_method_auto", "synthesize_note_arrays",
    "midi_to_wav_adsr", "synthesize_midi_adsr", "synthesize_midi",
    "apply_effect_chain", "audio_similarity", "note_slice_similarity",
    "optimize_all_notes", "synthesize_with_per_note_params",
    "verify_technique_by_audio_matching", "render_piano_roll",
    "AegisServer", "serve_main", "init_params", "init_train_state",
    "evaluate", "train", "validate", "run_benchmark", "sweep",
    "make_transcriber", "run_analyze_neural_batch", "train_on_batches",
    "run_spmd", "spmd", "dryrun_multichip", "warmup", "warmup_command",
    "optimize_single_note"])
def test_entry_point_raises_without_a_card_when_none_is_named(
        entry, monkeypatch, tmp_path):
    """No device named means the card: without one every entry point
    raises, and none runs the plain versions on the CPU instead."""
    import aegis_tpu_torch
    from aegis_tpu_torch.core import analyze
    from aegis_tpu_torch.engine import (auto, engine, financial, folder,
                                        poly, realtime, turbo)
    from aegis_tpu_torch.models import pitchnet
    from aegis_tpu_torch.core import hpss
    from aegis_tpu_torch.io import write_wav
    from aegis_tpu_torch.midi import events_to_midi
    from aegis_tpu_torch.synth import adsr, effects, fluidsynth, stems
    from aegis_tpu_torch.verify import (per_note, similarity, technique)
    from aegis_tpu_torch.viz import piano_roll
    from aegis_tpu_torch.serve import server
    from aegis_tpu_torch.models import train
    from aegis_tpu_torch.tools import (benchmark, inharmonic_sweep,
                                       validate_device)
    from aegis_tpu_torch.apps import live_monitor
    from aegis_tpu_torch.utils import mesh
    import graft_entry_torch
    from aegis_tpu_torch import __main__ as cli
    monkeypatch.setattr(stems, "find_demucs", lambda: None)
    event = {"note": 57, "start": 0, "end": 6, "velocity": 90,
             "track": "main", "technique": None, "confidence": 0.9}
    notes = [{"note": 57, "start": 0.0, "end": 0.1, "velocity": 90}]
    midi = events_to_midi([event], SR, 512, output=None)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, np.zeros(4096, np.float32), SR)
    cpu_auto = auto.AegisAutoEngine(sample_rate=SR, device="cpu")
    net = pitchnet.default_params("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.zeros(4096, np.float32)
    audio = TAudioConfig(sample_rate=SR)
    calls = {
        "pyin": lambda: tpyin.pyin(y, SR),
        "run_analyze": lambda: analyze.run_analyze(y, audio, TCFG),
        "dispatch_analyze": lambda: analyze.dispatch_analyze(y, audio, TCFG),
        "run_analyze_turbo": lambda: turbo.run_analyze_turbo(y, audio, TCFG),
        "run_analyze_batch": lambda: turbo.run_analyze_batch(y[None], audio,
                                                             TCFG),
        "run_analyze_streamed": lambda: turbo.run_analyze_streamed(y, audio,
                                                                   TCFG),
        "AegisEngine": lambda: engine.AegisEngine(sample_rate=SR),
        "AegisFinancialEngine": lambda: financial.AegisFinancialEngine(),
        "transcribe_folder": lambda: folder.transcribe_folder(str(tmp_path)),
        "StreamingTranscriber": lambda: realtime.StreamingTranscriber(),
        "resolve_device": lambda: aegis_tpu_torch.resolve_device(),
        "dispatch_analyze_poly": lambda: poly.dispatch_analyze_poly(y, SR),
        "AegisPolyEngine": lambda: poly.AegisPolyEngine(sample_rate=SR),
        "run_analyze_poly_turbo": lambda: turbo.run_analyze_poly_turbo(y, SR),
        "StreamingPolyTranscriber":
            lambda: realtime.StreamingPolyTranscriber(sample_rate=SR),
        "transcribe_folder_poly":
            lambda: folder.transcribe_folder(str(tmp_path), engine="poly"),
        "AegisAutoEngine": lambda: auto.AegisAutoEngine(sample_rate=SR),
        "dispatch_analyze_auto": lambda: auto.dispatch_analyze_auto(y,
                                                                    cpu_auto),
        "transcribe_folder_auto":
            lambda: folder.transcribe_folder(str(tmp_path), engine="auto"),
        "run_analyze_neural": lambda: pitchnet.run_analyze_neural(y, SR, 512,
                                                                  net),
        "dispatch_analyze_neural":
            lambda: pitchnet.dispatch_analyze_neural(y, SR, 512, net),
        "run_analyze_neural_streamed":
            lambda: pitchnet.run_analyze_neural_streamed(y, SR, 512, net),
        "transcribe_folder_neural":
            lambda: folder.transcribe_folder(str(tmp_path),
                                             pitch_backend="neural"),
        "hpss": lambda: hpss.hpss(y),
        "hpss_program": lambda: hpss.hpss_program(y),
        "separate_stems": lambda: stems.separate_stems(wav, str(tmp_path),
                                                       method="hpss"),
        "separate_hpss": lambda: stems.separate_hpss(wav, str(tmp_path)),
        "separate_stems_method_auto": lambda: stems.separate_stems(
            wav, str(tmp_path)),
        "synthesize_note_arrays":
            lambda: adsr.synthesize_note_arrays(notes, SR),
        "midi_to_wav_adsr": lambda: adsr.midi_to_wav_adsr(midi),
        "synthesize_midi_adsr": lambda: adsr.synthesize_midi_adsr(midi),
        "synthesize_midi": lambda: fluidsynth.synthesize_midi(midi),
        "apply_effect_chain": lambda: effects.apply_effect_chain(y, []),
        "audio_similarity": lambda: similarity.audio_similarity(y, y, SR),
        "note_slice_similarity":
            lambda: similarity.note_slice_similarity(y[None], y[None], SR),
        "optimize_all_notes":
            lambda: per_note.optimize_all_notes(y, [event], SR, 512),
        "synthesize_with_per_note_params":
            lambda: per_note.synthesize_with_per_note_params(
                [event], per_note.optimize_all_notes(
                    y, [event], SR, 512, mode="quick", device="cpu"), SR, 512),
        "verify_technique_by_audio_matching":
            lambda: technique.verify_technique_by_audio_matching(
                y, [dict(event, technique="bend")], SR, 512),
        "render_piano_roll": lambda: piano_roll.render_piano_roll(midi),
        "AegisServer": lambda: server.AegisServer(),
        "serve_main": lambda: server.main("127.0.0.1", 0),
        "init_params": lambda: pitchnet.init_params(0),
        "init_train_state": lambda: pitchnet.init_train_state(0),
        "evaluate": lambda: train.evaluate(net, n_clips=2),
        "train": lambda: train.train(steps=1, batch=2, clips=2,
                                     clip_len=4096),
        "validate": lambda: validate_device.validate(quiet=True),
        "run_benchmark": lambda: benchmark.run_benchmark(0.4),
        "sweep": lambda: inharmonic_sweep.sweep(b_values=(0.0,),
                                                mono_duration=1.0,
                                                poly_seeds=(1,), quiet=True),
        "make_transcriber": lambda: live_monitor.make_transcriber("v1", SR,
                                                                  None),
        "run_analyze_neural_batch": lambda: pitchnet.run_analyze_neural_batch(
            y[None], SR, 512, net),
        "train_on_batches": lambda: pitchnet.train_on_batches(
            pitchnet.params_to_numpy(net), [], [3e-4]),
        "run_spmd": lambda: mesh.run_spmd(turbo.run_analyze_batch, 1, 1,
                                          y[None], audio, TCFG),
        "spmd": lambda: mesh.spmd(turbo.run_analyze_batch, 1, 1, y[None],
                                  audio, TCFG),
        "dryrun_multichip": lambda: graft_entry_torch.dryrun_multichip(1),
        "warmup": lambda: cli.warmup(["v1"], [0.5]),
        "warmup_command": lambda: cli.main(["warmup", "--seconds", "0.5",
                                            "--pipelines", "v1"]),
        "optimize_single_note":
            lambda: per_note.optimize_single_note(y, event, SR, 512),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


# -------------------------------------------------------------- whole pYIN

def test_pyin_matches_jax(two_tone_22k):
    y, sr = two_tone_22k
    f0j, vfj, vpj = (np.asarray(a) for a in jpyin.pyin(y, sr))
    f0t, vft, vpt = (a.numpy() for a in tpyin.pyin(y, sr, device="cpu"))
    assert (vfj == vft).mean() == 1.0
    m = vfj & vft
    assert np.max(np.abs(f0j[m] - f0t[m]) / f0j[m]) < 1e-4
    assert np.all(np.isnan(f0t[~vft]))
    assert np.max(np.abs(vpj - vpt)) < 1e-4
