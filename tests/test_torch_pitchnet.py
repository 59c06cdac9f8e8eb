"""PitchNet inference of the port against the JAX package, on the CPU.

The committed checkpoint goes into both packages (flax's tree as is, the
port's ``PitchNet`` through ``params_from_numpy``), and the same inputs,
made from a NumPy seed, go through each stage and each program: the
features (population standard deviation), the logits, the decode, the
midpoint NaN-median, the onset backfill (also against the copied
``ref/pitchnet_post_ref.py``), the native, two-rate (uniform and gathered)
and financial programs, the streamed slabs against the fused program at
int16, the facades' events, the folder and the CLI.  Every comparison
states its tolerance.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aegis_tpu.engine.engine import AegisEngine as JaxEngine
from aegis_tpu.engine.financial import AegisFinancialEngine as JaxFinancial
from aegis_tpu.models import pitchnet as jpn
from aegis_tpu.ref import pitchnet_post_ref as jref

from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.engine.folder import transcribe_folder
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.models import pitchnet as tpn
from aegis_tpu_torch.ref import pitchnet_post_ref as tref
from aegis_tpu_torch.tools.signal_gen import generate_test_track, two_tone

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DISCRETE = ("voiced_flag", "rake_mask", "mute_mask", "artic_codes",
            "slide_codes")
# per-row tolerances (absolute unless said): the port's matmuls and sums run
# in another order than XLA's CPU programs.  f0 and trend (Hz) relative;
# mel_db in dB near the -80 dB floor; the financial rows at the pYIN
# financial program's 1e-4 (tests/test_torch_financial.py), the confidence
# rows at 3e-4: the trend stack's oscillators amplify f0's 1e-6 relative
# differences (read 1.2e-4 on two_tone)
ROW_TOL = {"f0": ("rtol", 2e-6), "voiced_probs": ("atol", 5e-6),
           "rms": ("atol", 1e-7), "onset_env": ("atol", 5e-5),
           "mel_db": ("atol", 3e-3), "trend": ("rtol", 1e-4),
           "financial_confidence": ("atol", 3e-4),
           "combined_confidence": ("atol", 3e-4),
           "adaptive_threshold": ("atol", 1e-4),
           "distortion_score": ("atol", 1e-4)}


def tone(sr, f, dur=1.0, decay=2.0):
    t = np.arange(int(sr * dur)) / sr
    env = np.exp(-decay * t)
    y = env * sum(a * np.sin(2 * np.pi * f * (k + 1) * t)
                  for k, a in enumerate([1.0, 0.5, 0.25]))
    return (0.8 * y / np.max(np.abs(y))).astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    return jpn.load_params()


@pytest.fixture(scope="module")
def net(tree):
    return tpn.pitchnet_from_numpy(tree, "cpu")


def assert_rows_match(got, ref, keys=None):
    for k in keys or ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k in DISCRETE or a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        m = ~np.isnan(b)
        how, tol = ROW_TOL[k]
        if how == "rtol":
            np.testing.assert_allclose(a[m], b[m], rtol=tol, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(a[m], b[m], rtol=0, atol=tol, err_msg=k)


def assert_same_events(got, ref, float_tol):
    """Every discrete field equal; float fields within ``float_tol``."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= float_tol, (k, g, r)
            else:
                assert g[k] == r[k], (k, g, r)


# ------------------------------------------------------------- the weights


def test_weights_are_the_jax_packages_checkpoint(tree, tmp_path):
    """The port reads its own byte copy of the checkpoint: the same meta,
    the same arrays, the feature-version and hidden gates."""
    theirs = Path(jpn._DEFAULT_WEIGHTS).read_bytes()
    assert Path(tpn._DEFAULT_WEIGHTS).read_bytes() == theirs
    assert tpn.have_default_weights()
    assert tpn.load_meta() == jpn.load_meta()
    mine = tpn.load_params()
    assert mine.keys() == tree.keys()
    for layer in tree:
        for p in ("kernel", "bias"):
            np.testing.assert_array_equal(mine[layer][p], tree[layer][p])
            assert mine[layer][p].dtype == np.float32
    sd = tpn.params_from_numpy(tree)
    assert sd["trunk.0.weight"].shape == (512, tpn.N_RFFT)
    assert sd["pitch.weight"].shape == (tpn.N_BINS, 256)
    assert sd["voiced.weight"].shape == (1, 256)
    np.testing.assert_array_equal(sd["trunk.1.weight"].numpy(),
                                  tree["Dense_1"]["kernel"].T)
    assert (tpn.FEATURE_VERSION, tpn.HIDDEN, tpn.WIN, tpn.N_BINS,
            tpn.FMIN_HZ, tpn.CENTS_PER_BIN, tpn.SR_NATIVE) == (
        jpn.FEATURE_VERSION, jpn.HIDDEN, jpn.WIN, jpn.N_BINS, jpn.FMIN_HZ,
        jpn.CENTS_PER_BIN, jpn.SR_NATIVE)

    z = dict(np.load(tpn._DEFAULT_WEIGHTS))
    for version, hidden in ((999, [512, 256]), (1, [64])):
        meta = json.loads(bytes(z["__meta__"]).decode())
        meta.update(feature_version=version, hidden=hidden)
        bad = dict(z, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                             dtype=np.uint8).copy())
        path = str(tmp_path / f"bad{version}.npz")
        np.savez_compressed(path, **bad)
        with pytest.raises(ValueError):
            tpn.load_params(path)
        with pytest.raises(ValueError):
            jpn.load_params(path)


def test_logits_match_flax(tree, net):
    """The same standardized spectra through flax's model and the port's
    PitchNet: logits within 2e-5 absolute (about 1e-6 of their range)."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((96, tpn.N_RFFT)).astype(np.float32)
    lj, vj = jpn.apply_model(tree, jnp.asarray(feats))
    with torch.no_grad():
        lt, vt = net(torch.from_numpy(feats))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=2e-5)


def test_featurize_uses_the_population_std():
    """featurize standardizes by the population standard deviation, as
    jnp.std (1.118 on [1, 2, 3, 4], not torch.std's 1.291); features
    within 5e-5 of JAX's on noise and on a tone."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((8, tpn.WIN)).astype(np.float32)
    w[0] = tone(22050, 196.0, 0.1)[:tpn.WIN]
    got = tpn.featurize(torch.from_numpy(w)).numpy()
    ref = np.asarray(jpn.featurize(jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)
    # population std of every feature row is 1 (up to the 1e-5 guard)
    np.testing.assert_allclose(got.std(axis=1, ddof=0), 1.0, atol=1e-4)
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    assert float(jnp.std(jnp.asarray(x))) == pytest.approx(1.118034, abs=1e-6)


def test_decode_matches_jax():
    """Softmax, first argmax, 9-bin local expectation (clipped at both
    ends of the grid): f0 within 1e-6 relative, vprob within 1e-7."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((64, tpn.N_BINS)) * 3).astype(np.float32)
    logits[0, 0] += 30.0           # peak at the lower edge
    logits[1, -1] += 30.0          # and at the upper one
    logits[2, 50] = logits[2, 90] = 40.0  # a tie: the first wins
    vlog = rng.standard_normal(64).astype(np.float32)
    fj, pj = jpn.decode_f0(jnp.asarray(logits), jnp.asarray(vlog))
    ft, pt = tpn.decode_f0(torch.from_numpy(logits), torch.from_numpy(vlog))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-7)


def test_nanmedian_takes_the_midpoint():
    """jnp.nanmedian's midpoint of the two middle non-NaN values; the
    port's _nanmedian gives it where torch.nanmedian gives the lower."""
    row = torch.tensor([[1.0, 2.0, 3.0, 4.0, float("nan")],
                        [5.0, float("nan"), 1.0, float("nan"), float("nan")],
                        [float("nan")] * 5, [3.0, 1.0, 2.0, 9.0, 7.0]])
    got = tpn._nanmedian(row).numpy()
    ref = np.asarray(jnp.nanmedian(jnp.asarray(row.numpy()), axis=-1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[:2], [2.5, 3.0])
    np.testing.assert_array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])
    assert float(torch.nanmedian(row[0])) == 2.0


@pytest.mark.parametrize("pattern", ["two_in_window", "four_in_window",
                                     "random"])
def test_smooth_f0_median_matches_jax_and_the_oracle(pattern):
    """Windows holding 2 and 4 non-NaN values (the midpoint cases) and a
    random track: within 1e-6 relative of JAX and of the NumPy oracle,
    unvoiced frames NaN."""
    rng = np.random.default_rng(3)
    T = 64
    if pattern == "two_in_window":
        voiced = np.zeros(T, bool)
        voiced[10:12] = voiced[30] = voiced[33] = True
    elif pattern == "four_in_window":
        voiced = np.ones(T, bool)
        voiced[5::5] = False
        voiced[:2] = False
    else:
        voiced = rng.random(T) < 0.7
    cents = rng.uniform(0, 4000, T)
    cents[rng.random(T) < 0.1] += 1200.0
    f0 = np.where(voiced, tpn.FMIN_HZ * 2 ** (cents / 1200.0),
                  np.nan).astype(np.float32)
    got = tpn.smooth_f0_median(torch.from_numpy(f0),
                               torch.from_numpy(voiced)).numpy()
    ref = np.asarray(jpn.smooth_f0_median(jnp.asarray(f0),
                                          jnp.asarray(voiced)))
    oracle = tref.smooth_f0_median_ref(np.nan_to_num(f0, nan=1.0), voiced)
    assert np.isnan(got[~voiced]).all()
    np.testing.assert_allclose(got[voiced], ref[voiced], rtol=1e-6)
    np.testing.assert_allclose(got[voiced], oracle[voiced], rtol=1e-6)


@pytest.mark.parametrize("fps", [43.07, 86.13])
def test_onset_backfill_matches_jax_and_the_oracle(fps):
    """Random voiced runs and onset peaks at both frame rates: voicing
    equal to JAX's and the oracle's, f0 and vprob within 1e-6 relative."""
    rng = np.random.default_rng(7)
    for _ in range(5):
        T = 96
        voiced = np.zeros(T, bool)
        for s in rng.integers(10, T - 10, 4):
            voiced[s:s + rng.integers(3, 12)] = True
        f0 = np.where(voiced, rng.uniform(80, 800, T), np.nan).astype(np.float32)
        vprob = np.where(voiced, rng.uniform(0.5, 1.0, T), 0.05).astype(np.float32)
        env = rng.random(T).astype(np.float32) * 0.15
        env[rng.integers(0, T, 6)] = rng.uniform(0.5, 1.0, 6)
        got = {k: v.numpy() for k, v in tpn._onset_backfill(
            {"f0": torch.from_numpy(f0), "voiced_flag": torch.from_numpy(voiced),
             "voiced_probs": torch.from_numpy(vprob)},
            torch.from_numpy(env), fps).items()}
        ref = {k: np.asarray(v) for k, v in jpn._onset_backfill(
            {"f0": jnp.asarray(f0), "voiced_flag": jnp.asarray(voiced),
             "voiced_probs": jnp.asarray(vprob)}, jnp.asarray(env),
            fps).items()}
        oracle = tref.onset_backfill_ref(
            {"f0": f0, "voiced_flag": voiced, "voiced_probs": vprob}, env, fps)
        for other in (ref, oracle):
            np.testing.assert_array_equal(got["voiced_flag"],
                                          other["voiced_flag"])
            m = other["voiced_flag"]
            np.testing.assert_allclose(got["f0"][m], other["f0"][m], rtol=1e-6)
            np.testing.assert_allclose(got["voiced_probs"],
                                       other["voiced_probs"], rtol=1e-6)


# ------------------------------------------------------------- the programs


PROGRAMS = {
    # name: (sr, hop, financial); 44 100 Hz / 512 frames the pitch head
    # uniformly at 256, 32 000 Hz / 512 has no integral 22 050 Hz hop and
    # gathers windows at rounded centres
    "native_22050": (22050, 512, False),
    "dual_uniform_44100": (44100, 512, False),
    "dual_gather_32000": (32000, 512, False),
    "financial_22050": (22050, 512, True),
    "financial_dual_44100": (44100, 512, True),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_match_jax(tree, net, name):
    """The Karplus-Strong test track through each program at the default
    int8 transport: discrete rows equal, float rows within ROW_TOL."""
    sr, hop, financial = PROGRAMS[name]
    y, _ = generate_test_track(sr=sr)
    ref = jpn.run_analyze_neural(y, sr, hop, tree, financial=financial)
    got = tpn.run_analyze_neural(y, sr, hop, net, financial=financial,
                                 device="cpu")
    assert got.keys() == ref.keys()
    assert got["f0"].shape == (1 + len(y) // hop,)
    assert got["voiced_flag"].any()
    assert_rows_match(got, ref)


@pytest.mark.parametrize("transport", ["int16", "float32"])
def test_transports_match_jax(tree, net, transport):
    y, _ = generate_test_track(sr=22050)
    ref = jpn.run_analyze_neural(y, 22050, 512, tree, transport=transport)
    got = tpn.run_analyze_neural(y, 22050, 512, net, transport=transport,
                                 device="cpu")
    assert_rows_match(got, ref)
    with pytest.raises(ValueError):
        tpn.run_analyze_neural(y, 22050, 512, net, transport="int4",
                               device="cpu")


def segments(sr, spec, seed):
    """Decaying tones of strongly varying amplitude (a quiet late section
    needs the track-global dB reference and onset maximum)."""
    rng = np.random.default_rng(seed)
    segs = []
    for f, amp, dur, decay in spec:
        t = np.arange(int(sr * dur)) / sr
        segs.append(amp * np.exp(-decay * t) * np.sin(2 * np.pi * f * t))
    y = np.concatenate(segs).astype(np.float32)
    return y + (0.003 * rng.standard_normal(len(y))).astype(np.float32)


STREAMED = {
    # sr, hop, slab, halo, track: many slabs at a low and a high frame rate
    "22050_hop512": (22050, 512, 32, 16, [(110.0, 0.9, 0.8, 1.5),
                                          (196.0, 0.08, 0.8, 1.5),
                                          (330.0, 0.5, 0.8, 1.5),
                                          (247.0, 0.04, 0.8, 1.5)], 5),
    "44100_hop256": (44100, 256, 48, 8, [(110.0, 0.9, 0.5, 2.5),
                                         (196.0, 0.08, 0.5, 2.5),
                                         (330.0, 0.5, 0.5, 2.5),
                                         (247.0, 0.04, 0.5, 2.5),
                                         (147.0, 0.3, 0.5, 2.5)], 11),
}


@pytest.mark.parametrize("case", sorted(STREAMED))
def test_streamed_equals_fused_and_jax(tree, net, case):
    """The port's streamed slabs against the port's fused program at int16
    (one scale a track; the JAX tests' contract: discrete rows equal,
    floats within rtol 1e-5 / atol 1e-6), and against the JAX streamed
    rows (ROW_TOL)."""
    sr, hop, slab, halo, spec, seed = STREAMED[case]
    y = segments(sr, spec, seed)
    fused = tpn.run_analyze_neural(y, sr, hop, net, fetch_mel=False,
                                   transport="int16", device="cpu")
    streamed = tpn.run_analyze_neural_streamed(
        y, sr, hop, net, fetch_mel=False, slab_frames=slab,
        halo_frames=halo, device="cpu")
    for k in ("voiced_flag", "rake_mask"):
        np.testing.assert_array_equal(streamed[k], fused[k], err_msg=k)
    for k in ("f0", "voiced_probs", "rms", "onset_env"):
        np.testing.assert_allclose(
            np.nan_to_num(streamed[k]), np.nan_to_num(fused[k]),
            rtol=1e-5, atol=1e-6, err_msg=k)
    ref = jpn.run_analyze_neural_streamed(y, sr, hop, tree, fetch_mel=False,
                                          slab_frames=slab, halo_frames=halo)
    assert_rows_match(streamed, ref)
    with pytest.raises(ValueError):  # no integral 22.05 kHz hop
        tpn.run_analyze_neural_streamed(y[:4096], 48000, 512, net,
                                        device="cpu")


# ------------------------------------------------------ facades and surfaces


@pytest.mark.parametrize("sr", [22050, 44100])
@pytest.mark.parametrize("mode", ["off", "stream"])
def test_engine_events_match_jax(sr, mode):
    """AegisEngine(pitch_backend="neural") against the JAX engine, fused
    and streamed, on the Karplus-Strong track: events dict for dict (every
    discrete field equal, floats within 1e-4, the v1 engine's tolerance),
    the forward onset snap applied from the raw data's marker."""
    y, _ = generate_test_track(sr=sr)
    kw = dict(pitch_backend="neural", turbo_mode=mode)
    jeng = JaxEngine(sample_rate=sr, backend="device")
    teng = AegisEngine(sample_rate=sr, device="cpu")
    raw_j, raw_t = jeng.audio_to_midi(y, **kw), teng.audio_to_midi(y, **kw)
    assert str(raw_t["pitch_backend"]) == "neural"
    ev_j = jeng.extract_events(raw_j, None, confidence_threshold=0.3)
    ev_t = teng.extract_events(raw_t, None, confidence_threshold=0.3)
    assert ev_t
    assert_same_events(ev_t, ev_j, 1e-4)


def test_tiles_and_odd_rates_run_the_fused_program():
    """"tiles", and "stream" at a rate with no integral 22 050 Hz hop, run
    the fused program (the JAX engine's semantics, with a log line)."""
    y = np.concatenate([tone(32000, 196.0, 0.6), tone(32000, 293.66, 0.6)])
    eng = AegisEngine(sample_rate=32000, device="cpu")
    fused = eng.audio_to_midi(y, pitch_backend="neural", turbo_mode="off")
    for mode in ("tiles", "stream"):
        raw = eng.audio_to_midi(y, pitch_backend="neural", turbo_mode=mode)
        np.testing.assert_array_equal(raw["f0"], fused["f0"])
    ev = eng.extract_events(fused, None, confidence_threshold=0.3)
    assert {55, 62} <= {e["note"] for e in ev}
    with pytest.raises(ValueError):
        eng.audio_to_midi(y, pitch_backend="bogus")


@pytest.mark.parametrize("sr", [22050, 44100])
def test_financial_engine_matches_jax(sr):
    """AegisFinancialEngine(pitch_backend="neural"): the financial rows
    within ROW_TOL of the JAX engine's, events dict for dict (floats
    within 1e-4)."""
    y = two_tone(sr=sr)
    jeng = JaxFinancial(sample_rate=sr, backend="device")
    teng = AegisFinancialEngine(sample_rate=sr, device="cpu")
    a_j = jeng.analyze(y, pitch_backend="neural")
    a_t = teng.analyze(y, pitch_backend="neural", turbo_mode="stream")
    assert_rows_match(a_t, a_j, [k for k in a_j
                                 if k not in ("y", "pitch_backend")])
    ev_j, info_j = jeng.extract_events(a_j, confidence_threshold=0.3)
    ev_t, info_t = teng.extract_events(a_t, confidence_threshold=0.3)
    assert {55, 62} <= {e["note"] for e in ev_t}
    assert_same_events(ev_t, ev_j, 1e-4)
    assert info_t["threshold"] == pytest.approx(info_j["threshold"], abs=1e-5)


def test_neural_folder_equals_the_facade(tmp_path):
    """transcribe_folder(pitch_backend="neural"), v1 and financial: the
    MIDI bytes of each track equal the per-track facade's."""
    sr = 22050
    clips = {"g.wav": np.concatenate([tone(sr, 196.0, 0.6),
                                      tone(sr, 293.66, 0.6)]),
             "a.wav": tone(sr, 220.0, 0.9)}
    for name, y in clips.items():
        write_wav(str(tmp_path / name), y, sr)
    out = tmp_path / "mid"
    results = transcribe_folder(str(tmp_path), str(out), sample_rate=sr,
                                pitch_backend="neural",
                                confidence_threshold=0.3, device="cpu")
    assert len(results) == 2
    eng = AegisEngine(sample_rate=sr, device="cpu")
    for wav, mid, n in results:
        ref = io.BytesIO()
        raw = eng.audio_to_midi(wav, None, pitch_backend="neural",
                                fetch_mel=False)
        expected = eng.extract_events(raw, ref, confidence_threshold=0.3)
        assert n == len(expected) > 0
        assert Path(mid).read_bytes() == ref.getvalue()

    fin = transcribe_folder(str(tmp_path), str(tmp_path / "fin"),
                            sample_rate=sr, pitch_backend="neural",
                            engine="financial", device="cpu")
    feng = AegisFinancialEngine(sample_rate=sr, device="cpu")
    for wav, mid, n in fin:
        ref = str(tmp_path / "ref.mid")
        assert feng.audio_to_midi_financial(wav, ref, pitch_backend="neural")
        assert Path(mid).read_bytes() == Path(ref).read_bytes()
    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), sample_rate=sr,
                          pitch_backend="bogus", device="cpu")


def test_cli_neural(tmp_path):
    """`transcribe --pitch-backend neural` and `batch --pitch-backend
    neural` on the CPU."""
    y = np.concatenate([tone(22050, 196.0, 0.6), tone(22050, 293.66, 0.6)])
    wav = tmp_path / "in.wav"
    write_wav(str(wav), y, 22050)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for args in (["transcribe", str(wav), str(tmp_path / "t.mid"), "--sr",
                  "22050", "--pitch-backend", "neural", "--confidence", "0.3"],
                 ["batch", str(tmp_path), "--pitch-backend", "neural",
                  "--output-dir", str(tmp_path / "b"), "--confidence", "0.3"]):
        proc = subprocess.run([sys.executable, "-m", "aegis_tpu_torch", *args,
                               "--device", "cpu"], cwd=REPO,
                              capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode == 0, proc.stderr
    for mid in (tmp_path / "t.mid", tmp_path / "b" / "in.mid"):
        assert {55, 62} <= {n["note"] for n in midi_to_notes(str(mid))}
