"""aegis_tpu_torch's tiled, streamed and folder-batch modes vs the JAX
package's turbo functions and vs the port's own fused program, on the CPU
(the seam, batch and streaming contracts of tests/test_turbo.py), and the
``financial`` / ``batch`` / ``transcribe --turbo stream`` CLI commands."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aegis_tpu.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu.engine import turbo as jturbo
from aegis_tpu.engine.poly import transcribe_folder as jax_transcribe_folder
from aegis_tpu.io import write_wav
from aegis_tpu.midi.decode import midi_to_notes
from aegis_tpu.tools.signal_gen import generate_scale_benchmark, generate_test_track
from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1
from aegis_tpu_torch import config as tconfig
from aegis_tpu_torch.core.analyze import PCM8_BLOCK, run_analyze
from aegis_tpu_torch.core.events import extract_events_financial, extract_events_v1
from aegis_tpu_torch.engine import turbo as tturbo
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.engine.folder import transcribe_folder

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 22050
AUDIO = AudioConfig(sample_rate=SR)
PYIN = PyinConfig()
SMALL = TurboConfig(tile_frames=16, halo_frames=8)


def port_turbo(tc):
    """The port's own TurboConfig with the fields of the JAX package's."""
    return tconfig.TurboConfig(**dataclasses.asdict(tc))


# the port is handed its own config classes
TAUDIO = tconfig.AudioConfig(sample_rate=SR)
TPYIN = tconfig.PyinConfig()
TSMALL = port_turbo(SMALL)
# the JAX reference on ONE device, as the port runs: on the test suite's
# 8-device CPU mesh the JAX package pads the tile count to a multiple of 8,
# and the distortion score averages over that padding
ONE = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "time"))


@pytest.fixture(scope="module")
def track():
    return generate_test_track(sr=SR)[0]


def _v1_events(raw, conf=0.55):
    return events_to_seconds(extract_events_v1(
        rake_mask=raw["rake_mask"], f0=np.nan_to_num(raw["f0"]),
        voiced_flag=raw["voiced_flag"], active_probs=raw["voiced_probs"],
        rms=raw["rms"], sr=SR, hop_length=AUDIO.hop_length,
        confidence_threshold=conf, onset_env=raw.get("onset_env")),
        SR, AUDIO.hop_length)


def _fin_events(raw):
    ev, _ = extract_events_financial(
        rake_mask=raw["rake_mask"], f0=raw["f0"],
        voiced_flag=raw["voiced_flag"], active_probs=raw["voiced_probs"],
        rms=raw["rms"], sr=SR, hop_length=AUDIO.hop_length,
        trend=raw["trend"], artic_codes=raw["artic_codes"],
        slide_codes=raw["slide_codes"],
        financial_confidence=raw["financial_confidence"],
        confidence_threshold=0.45)
    return events_to_seconds(ev, SR, AUDIO.hop_length)


def _rows_match(got, ref, rows, f0_rtol=1e-4, atol=1e-4):
    """The port's rows against the JAX package's on the same mode."""
    for k in rows:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if r.dtype == bool:
            assert (g == r).mean() > 0.999, k
        elif k in ("artic_codes", "slide_codes"):
            assert (g == r).mean() >= 0.99, k
        elif k in ("f0", "trend"):
            m = ~np.isnan(r) & ~np.isnan(g)
            assert (np.isnan(g) == np.isnan(r)).mean() > 0.999, k
            assert np.max(np.abs(g[m] - r[m]) / r[m]) < f0_rtol, k
        else:
            np.testing.assert_allclose(g, r, atol=atol, err_msg=k)


# ----------------------------------------------------------------- tiles

@pytest.mark.parametrize("tile,halo", [(48, 24), (40, 16), (96, 32)])
def test_tiles_match_fused_and_jax(track, tile, halo):
    """Seams: the tiled rows agree with the port's fused program, events
    are identical to it, and the rows match the JAX tiled program's."""
    tc = TurboConfig(tile_frames=tile, halo_frames=halo)
    out_t = tturbo.run_analyze_turbo(track, TAUDIO, TPYIN, 0.6, turbo=port_turbo(tc),
                                     transport="float32", device="cpu")
    out_s = run_analyze(track, TAUDIO, TPYIN, 0.6, transport="float32", device="cpu")
    assert out_t["f0"].shape == out_s["f0"].shape
    vf_t, vf_s = out_t["voiced_flag"], out_s["voiced_flag"]
    assert (vf_t == vf_s).mean() > 0.98  # rare seam flips allowed
    m = vf_t & vf_s
    assert np.nanmax(np.abs(out_t["f0"][m] - out_s["f0"][m])
                     / out_s["f0"][m]) < 0.01
    np.testing.assert_allclose(out_t["rms"], out_s["rms"], atol=1e-5)
    assert np.abs(out_t["mel_db"] - out_s["mel_db"]).max() < 1e-3
    assert out_t["onset_env"][0] == 0.0
    assert note_event_f1(_v1_events(out_s), _v1_events(out_t))["f1"] == 1.0

    ref = jturbo.run_analyze_turbo(track, AUDIO, PYIN, 0.6, turbo=tc,
                                   transport="float32", mesh=ONE)
    _rows_match(out_t, ref, ("f0", "voiced_flag", "voiced_probs", "rms",
                             "rake_mask", "onset_env"))
    # dB of matmul-DFT power: at -74 dB the JAX tiled program's mel sits
    # 1.6e-3 dB from the port's tiled and fused programs, which agree to
    # 1e-3 (above)
    assert np.abs(out_t["mel_db"] - ref["mel_db"]).max() < 2e-3


def test_tiles_financial_match_fused_and_jax(track):
    tc = TurboConfig(tile_frames=48, halo_frames=24)
    ref_fused = run_analyze(track, TAUDIO, TPYIN, 0.6, financial=True,
                            transport="float32", device="cpu")
    raw = tturbo.run_analyze_turbo(track, TAUDIO, TPYIN, 0.6, turbo=port_turbo(tc),
                                   transport="float32", financial=True, device="cpu")
    T = len(ref_fused["f0"])
    assert (raw["mute_mask"][:T] == ref_fused["mute_mask"]).mean() > 0.99
    assert (raw["voiced_flag"][:T] == ref_fused["voiced_flag"]).mean() > 0.98
    assert note_event_f1(_fin_events(ref_fused), _fin_events(raw))["f1"] == 1.0

    ref = jturbo.run_analyze_turbo(track, AUDIO, PYIN, 0.6, turbo=tc,
                                   transport="float32", financial=True, mesh=ONE)
    _rows_match(raw, ref, ("f0", "voiced_flag", "mute_mask", "trend",
                           "artic_codes", "slide_codes",
                           "financial_confidence", "combined_confidence"))
    for k in ("adaptive_threshold", "distortion_score"):
        assert np.ndim(raw[k]) == 0
        assert abs(float(raw[k]) - float(ref[k])) < 1e-4, k


# ----------------------------------------------------------------- batch

def test_batch_two_tracks_match_jax():
    t = np.arange(SR // 2) / SR
    ys = np.stack([(0.4 * np.sin(2 * np.pi * 196.0 * t)).astype(np.float32),
                   (0.4 * np.sin(2 * np.pi * 261.63 * t)).astype(np.float32)])
    tc = TurboConfig(tile_frames=16, halo_frames=8)
    out = tturbo.run_analyze_batch(ys, TAUDIO, TPYIN, 0.6, turbo=port_turbo(tc), device="cpu")
    assert out["f0"].shape[0] == 2
    for b, expect in enumerate((196.0, 261.63)):
        f0 = out["f0"][b][out["voiced_flag"][b]]
        assert abs(np.median(f0) - expect) / expect < 0.01
    ref = jturbo.run_analyze_batch(ys, AUDIO, PYIN, 0.6, turbo=tc, mesh=ONE)
    _rows_match(out, ref, ("f0", "voiced_flag", "voiced_probs", "rms",
                           "rake_mask", "onset_env"))


def test_batch_financial_per_track_scalars():
    """Per-track scalars (adaptive threshold, distortion score) come back
    per track, as the JAX package's do, and each track's rows equal the
    track run alone: the dB reference is the track's own."""
    t = np.arange(SR) / SR
    loud = (0.7 * np.sin(2 * np.pi * 196.0 * t) * np.exp(-t)).astype(np.float32)
    quiet = (0.02 * np.sin(2 * np.pi * 392.0 * t)).astype(np.float32)
    ys = np.stack([loud, quiet])
    out = tturbo.run_analyze_batch(ys, TAUDIO, TPYIN, financial=True, device="cpu")
    ref = jturbo.run_analyze_batch(ys, AUDIO, PYIN, financial=True, mesh=ONE)
    for k in ("adaptive_threshold", "distortion_score"):
        assert out[k].shape == (2,)
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4)
    assert out["trend"].shape[0] == 2
    for b, y in enumerate(ys):
        alone = tturbo.run_analyze_turbo(y, TAUDIO, TPYIN, financial=True, device="cpu")
        np.testing.assert_array_equal(out["mel_db"][b], alone["mel_db"])
        np.testing.assert_array_equal(out["voiced_flag"][b],
                                      alone["voiced_flag"])
        assert out["adaptive_threshold"][b] == alone["adaptive_threshold"]


# ---------------------------------------------------------------- stream

def test_streamed_matches_tiles_v1(track):
    """Streamed == tiled bit for bit on the pYIN rows with the int16
    transport (slab edges splice real audio, pass-1 gives the dB
    reference), with a slab count that does not divide the track."""
    tr = tturbo.run_analyze_turbo(track, TAUDIO, TPYIN, 0.6, turbo=TSMALL, device="cpu")
    st = tturbo.run_analyze_streamed(track, TAUDIO, TPYIN, 0.6, turbo=TSMALL,
                                     slab_tiles=8, transport="int16", device="cpu")
    assert (st["voiced_flag"] == tr["voiced_flag"]).all()
    m = st["voiced_flag"]
    assert np.array_equal(st["f0"][m], tr["f0"][m])
    np.testing.assert_array_equal(st["rms"], tr["rms"])
    assert (st["rake_mask"] == tr["rake_mask"]).mean() > 0.999
    np.testing.assert_allclose(st["onset_env"], tr["onset_env"], atol=1e-3)

    ref = jturbo.run_analyze_streamed(track, AUDIO, PYIN, 0.6, turbo=SMALL,
                                      slab_tiles=8, transport="int16", mesh=ONE)
    _rows_match(st, ref, ("f0", "voiced_flag", "voiced_probs", "rms",
                          "rake_mask", "onset_env"))


def test_streamed_financial_matches_tiles_and_jax(track):
    tr = tturbo.run_analyze_turbo(track, TAUDIO, TPYIN, 0.6, turbo=TSMALL,
                                  financial=True, device="cpu")
    st = tturbo.run_analyze_streamed(track, TAUDIO, TPYIN, 0.6, turbo=TSMALL,
                                     slab_tiles=8, financial=True,
                                     transport="int16", device="cpu")
    assert (st["mute_mask"] == tr["mute_mask"]).all()
    assert note_event_f1(_fin_events(tr), _fin_events(st))["f1"] == 1.0
    both = st["voiced_flag"] & tr["voiced_flag"]
    assert np.nanmax(np.abs(st["trend"][both] - tr["trend"][both])) < 1e-3

    ref = jturbo.run_analyze_streamed(track, AUDIO, PYIN, 0.6, turbo=SMALL,
                                      slab_tiles=8, financial=True,
                                      transport="int16", mesh=ONE)
    _rows_match(st, ref, ("f0", "voiced_flag", "mute_mask", "trend",
                          "artic_codes", "slide_codes",
                          "financial_confidence", "combined_confidence"))
    for k in ("adaptive_threshold", "distortion_score"):
        assert abs(float(st[k]) - float(ref[k])) < 1e-4, k
    assert note_event_f1(_fin_events(ref), _fin_events(st))["f1"] == 1.0


def test_streamed_int8_default(track):
    """The int8 stream (the default) agrees with the int16 stream on
    voicing, pitch and events, and with the JAX package's int8 stream."""
    assert (SMALL.tile_frames * 8 * AUDIO.hop_length) % PCM8_BLOCK == 0
    st8 = tturbo.run_analyze_streamed(track, TAUDIO, TPYIN, 0.6, turbo=TSMALL,
                                      slab_tiles=8, device="cpu")
    st16 = tturbo.run_analyze_streamed(track, TAUDIO, TPYIN, 0.6, turbo=TSMALL,
                                       slab_tiles=8, transport="int16", device="cpu")
    assert (st8["voiced_flag"] == st16["voiced_flag"]).mean() > 0.99
    both = st8["voiced_flag"] & st16["voiced_flag"]
    np.testing.assert_allclose(st8["f0"][both], st16["f0"][both], rtol=1e-3)
    ev8 = _v1_events(st8, conf=0.7)
    assert note_event_f1(_v1_events(st16, conf=0.7), ev8)["f1"] == 1.0

    ref = jturbo.run_analyze_streamed(track, AUDIO, PYIN, 0.6, turbo=SMALL,
                                      slab_tiles=8, mesh=ONE)
    _rows_match(st8, ref, ("f0", "voiced_flag", "voiced_probs", "rms",
                           "rake_mask", "onset_env"))
    assert note_event_f1(_v1_events(ref, conf=0.7), ev8)["f1"] == 1.0


def test_stream_mode_via_facades(track):
    eng = AegisEngine(sample_rate=SR, device="cpu")
    raw_s = eng.audio_to_midi(track, None, turbo_mode="stream",
                              turbo_config=TSMALL)
    raw_d = eng.audio_to_midi(track, None)
    ev_s = eng.extract_events(raw_s, None, confidence_threshold=0.5)
    ev_d = eng.extract_events(raw_d, None, confidence_threshold=0.5)
    assert {e["note"] for e in ev_s} == {e["note"] for e in ev_d}

    fin = AegisFinancialEngine(sample_rate=SR, device="cpu")
    a = fin.analyze(track, turbo_mode="stream", turbo_config=TSMALL)
    ev, info = fin.extract_events(a)
    assert ev and "adaptive_threshold" in a
    a_t = fin.analyze(track, turbo_mode="tiles", turbo_config=TSMALL)
    ev_t, _ = fin.extract_events(a_t)
    assert [(e["note"], e["start"]) for e in ev] == \
        [(e["note"], e["start"]) for e in ev_t]


# ---------------------------------------------------------------- folder

@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    """Three short WAVs of different lengths."""
    d = tmp_path_factory.mktemp("folder")
    ks = generate_test_track(sr=SR)[0]
    clips = {"a_ks.wav": ks, "b_scale.wav": generate_scale_benchmark(sr=SR)[0],
             "c_short.wav": ks[: 2 * SR]}
    for name, y in clips.items():
        write_wav(str(d / name), y, SR)
    return d


@pytest.mark.parametrize("engine", ["v1", "financial"])
def test_transcribe_folder_matches_facade_and_jax(wav_folder, tmp_path, engine):
    out_dir = tmp_path / "mid"
    results = transcribe_folder(str(wav_folder), str(out_dir), engine=engine,
                                device="cpu")
    assert [os.path.basename(w) for w, _, _ in results] == \
        ["a_ks.wav", "b_scale.wav", "c_short.wav"]
    for wav, mid, n in results:
        assert os.path.exists(mid) and midi_to_notes(mid)
        if engine == "v1":
            eng = AegisEngine(sample_rate=SR, device="cpu")
            n_facade = len(eng.extract_events(eng.audio_to_midi(wav), None))
        else:
            eng = AegisFinancialEngine(sample_rate=SR, device="cpu")
            n_facade = len(eng.extract_events(eng.analyze(wav))[0])
        assert n == n_facade > 0, wav
    ref = jax_transcribe_folder(str(wav_folder), str(tmp_path / "jax"),
                                engine=engine)
    assert [n for _, _, n in results] == [n for _, _, n in ref]


# ------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO),
             "OMP_NUM_THREADS": "1"})


def test_cli_financial_batch_and_stream(wav_folder, tmp_path):
    wav = str(wav_folder / "a_ks.wav")
    out = str(tmp_path / "fin.mid")
    proc = _cli("financial", wav, out)
    assert proc.returncode == 0, proc.stderr
    assert {40, 45, 50} <= {n["note"] for n in midi_to_notes(out)}

    out = str(tmp_path / "stream.mid")
    proc = _cli("transcribe", wav, out, "--sr", "22050", "--turbo", "stream",
                "--confidence", "0.5")
    assert proc.returncode == 0, proc.stderr
    assert {40, 45, 50} <= {n["note"] for n in midi_to_notes(out)}

    proc = _cli("batch", str(wav_folder), "--output-dir",
                str(tmp_path / "b"), "--engine", "financial")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count(" events)") == 3
    assert len(list((tmp_path / "b").glob("*.mid"))) == 3
