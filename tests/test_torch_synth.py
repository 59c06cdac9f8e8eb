"""The port's ADSR synth and effect chain (aegis_tpu_torch/synth/) on the CPU
against the JAX package's (aegis_tpu/synth/), case for case with
tests/test_synth.py, plus parity.

Tolerances (max abs): render_notes / synthesize_note_arrays 1e-5 with the
integer attack, decay and release lengths equal; distortion and delay
1e-6; reverb 1e-5; the chorus 1e-5 with its source samples equal on the same
LFO, and its LFO within one float32 ulp of XLA's sine; WAV bytes within one
int16 step.
"""

import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aegis_tpu.synth import adsr as JA
from aegis_tpu.synth import effects as JE
from aegis_tpu_torch.io.wav import read_wav
from aegis_tpu_torch.midi.smf import MidiFile, MidiMessage, MidiTrack
from aegis_tpu_torch.synth import adsr as TA
from aegis_tpu_torch.synth import effects as TE
from aegis_tpu_torch.synth.adsr import (analyze_envelope, midi_to_wav_adsr,
                                        synthesize_midi_adsr,
                                        synthesize_note_arrays)
from aegis_tpu_torch.synth.effects import apply_effect_chain, distortion
from aegis_tpu_torch.synth.presets import EFFECT_PRESETS, GUITAR_ADSR_PRESETS

SR = 22050
CPU = torch.device("cpu")
ONE_LSB = 1.0 / 32767 + 1e-9


def _simple_midi(notes=(60, 64, 67)):
    mid = MidiFile()
    tr = MidiTrack()
    mid.tracks.append(tr)
    for n in notes:
        tr.append(MidiMessage("note_on", note=n, velocity=100, time=0))
        tr.append(MidiMessage("note_off", note=n, velocity=0, time=480))
    return mid.save(None)


def _score(n=25, seed=0):
    """A note list with every note of its own length, start and velocity."""
    return [{"note": 40 + (7 * k) % 40, "start": 0.37 * k,
             "end": 0.37 * k + 0.2 + 0.9 * ((k * 13) % 7) / 7,
             "velocity": 30 + 3 * k} for k in range(n)]


def _per_note(n, seed):
    rng = np.random.default_rng(seed)
    return {"attack_ms": rng.uniform(1, 400, n).astype(np.float32),
            "decay_ms": rng.uniform(1, 900, n).astype(np.float32),
            "sustain_level": rng.uniform(0.05, 1.0, n).astype(np.float32),
            "release_ms": rng.uniform(5, 900, n).astype(np.float32),
            "waveform_code": rng.integers(0, 4, n).astype(np.int32)}


def _wav_close(a: bytes, b: bytes) -> None:
    (xa, ra), (xb, rb) = read_wav(a), read_wav(b)
    assert ra == rb and xa.shape == xb.shape
    assert np.abs(xa - xb).max() <= ONE_LSB


# ---------------------------------------------- tests/test_synth.py, ported

def test_note_render_frequency():
    notes = [{"note": 69, "start": 0.0, "end": 0.5, "velocity": 100}]
    audio = synthesize_note_arrays(notes, SR, waveform="sine", release_ms=10,
                                   device="cpu")
    seg = audio[int(0.05 * SR): int(0.4 * SR)]
    zc = np.sum(np.abs(np.diff(np.signbit(seg))))
    est_freq = zc / 2 / (len(seg) / SR)
    assert abs(est_freq - 440.0) < 25
    ref = JA.synthesize_note_arrays(notes, SR, waveform="sine", release_ms=10)
    assert np.abs(audio - ref).max() < 1e-5


def test_adsr_envelope_shape():
    notes = [{"note": 60, "start": 0.0, "end": 1.0, "velocity": 127}]
    kw = dict(attack_ms=100, decay_ms=100, sustain_level=0.5, release_ms=100,
              waveform="sine")
    audio = synthesize_note_arrays(notes, SR, device="cpu", **kw)
    a = np.abs(audio[: int(0.1 * SR)])
    peak = np.abs(audio).max()
    sustain_amp = np.abs(audio[int(0.4 * SR): int(0.8 * SR)]).max()
    assert a[: len(a) // 4].max() < a[len(a) // 2:].max()
    assert 0.3 * peak < sustain_amp < 0.7 * peak
    assert np.abs(audio - JA.synthesize_note_arrays(notes, SR, **kw)).max() \
        < 1e-5


def test_midi_to_wav_and_presets():
    midi = _simple_midi()
    wav = midi_to_wav_adsr(midi, sample_rate=SR, device="cpu")
    audio, sr = read_wav(wav)
    assert sr == SR
    assert len(audio) > SR
    assert 0.5 < np.abs(audio).max() <= 1.0
    _wav_close(wav, JA.midi_to_wav_adsr(midi, sample_rate=SR))

    for preset in GUITAR_ADSR_PRESETS:
        wav2 = synthesize_midi_adsr(midi, preset=preset, sample_rate=SR,
                                    device="cpu")
        assert wav2 is not None and len(wav2) > 1000
        _wav_close(wav2, JA.synthesize_midi_adsr(midi, preset=preset,
                                                 sample_rate=SR))


def test_analyze_envelope_roundtrip():
    notes = [{"note": 64, "start": 0.0, "end": 1.0, "velocity": 127}]
    audio = synthesize_note_arrays(
        notes, SR, attack_ms=50, decay_ms=100, sustain_level=0.6,
        release_ms=150, waveform="sine", device="cpu")
    params = analyze_envelope(audio, SR)
    assert 5 <= params["attack_ms"] <= 200
    assert 0.2 <= params["sustain_level"] <= 1.0


def test_distortion_and_chain():
    x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(SR) / SR)).astype(np.float32)
    d = distortion(torch.from_numpy(x), 0.8).numpy()
    assert np.abs(d).max() <= 1.0
    assert np.sqrt((d ** 2).mean()) > np.sqrt((x ** 2).mean())

    out = apply_effect_chain(
        x,
        [("distortion", {"drive": 0.4}), ("chorus", {"depth": 0.002}),
         ("reverb", {"room_size": 0.5}),
         ("delay", {"delay_ms": 100, "feedback": 0.3})],
        sr=SR, device="cpu")
    assert out.shape == x.shape
    assert np.abs(out).max() <= 1.0 + 1e-5
    assert not np.allclose(out, x)


def test_effect_chain_unknown_skipped():
    x = np.zeros(SR, np.float32)
    out = apply_effect_chain(x, [("flanger", {})], sr=SR, device="cpu")
    np.testing.assert_allclose(out, x)


def test_delay_feedback_one_no_crash():
    """feedback >= 1.0 clamps to a decaying loop instead of overflowing the
    echo-count formula."""
    y = np.zeros(4096, np.float32)
    y[0] = 1.0
    cfg = [("delay", {"feedback": 1.0, "delay_ms": 20.0})]
    out = apply_effect_chain(y, cfg, device="cpu")
    assert out.shape == y.shape and np.isfinite(out).all()
    assert np.abs(out[400:]).max() > 0  # echoes actually present
    assert np.abs(out - np.asarray(JE.apply_effect_chain(y, cfg))).max() < 1e-6


# ------------------------------------------------------- parity with JAX

@pytest.mark.parametrize("sr", [22050, 44100])
def test_segment_lengths_and_envelope_equal_jax(sr):
    """sr * ms / 1000 is floored to whole samples: XLA folds it into
    ms * (f32(sr) * f32(0.001)), and a true division would move segment
    boundaries by a sample (115 of these 200 001 values at 22 050 Hz)."""
    ms = np.linspace(0.5, 1000, 200001).astype(np.float32)
    t = torch.from_numpy(ms)
    ref = np.asarray(jax.jit(lambda a: jnp.floor(sr * a / 1000.0))(ms))
    for got in TA.segment_lengths(t, t, t, sr):
        np.testing.assert_array_equal(got.numpy(), ref)

    # the whole envelope of notes whose segments end off the sample grid
    k = np.arange(30000, dtype=np.float32)
    rng = np.random.default_rng(sr)
    for _ in range(8):
        n, a, d, r = (np.float32(v) for v in (rng.uniform(2000, 30000),
                                              rng.uniform(0.5, 300),
                                              rng.uniform(0.5, 300),
                                              rng.uniform(0.5, 300)))
        s = np.float32(rng.uniform(0.05, 1.0))
        want = np.asarray(jax.jit(JA._envelope, static_argnums=2)(
            k, n, sr, a, d, s, r))
        got = TA._envelope(torch.from_numpy(k), torch.tensor(n), sr,
                           torch.tensor(a), torch.tensor(d), torch.tensor(s),
                           torch.tensor(r)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("waveform", ["sine", "sawtooth", "square", "triangle"])
@pytest.mark.parametrize("sr", [22050, 44100])
def test_synthesize_note_arrays_matches_jax(sr, waveform):
    """Notes of many lengths and per-note envelopes: t = k * f32(1/sr) as
    XLA computes k / sr; with a true division the phase of a long note
    drifts by whole ulps of (freq * t)."""
    notes = _score()
    per_note = _per_note(len(notes), sr)
    per_note.pop("waveform_code")
    got = synthesize_note_arrays(notes, sr, waveform=waveform,
                                 per_note=per_note, device="cpu")
    ref = JA.synthesize_note_arrays(notes, sr, waveform=waveform,
                                    per_note=per_note)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("sr", [22050, 44100])
def test_render_notes_matches_jax(sr):
    """The batched render and the block-aligned one-hot mixdown, every
    waveform, notes crossing block edges and one past the end."""
    rng = np.random.default_rng(7)
    N, max_len, total = 12, 8192, 60000
    f = rng.uniform(80, 3000, N).astype(np.float32)
    st = rng.integers(0, total, N).astype(np.int32)
    ln = rng.integers(100, max_len - 1, N).astype(np.int32)
    v = rng.uniform(0, 127, N).astype(np.float32)
    pn = _per_note(N, 3)
    args = (f, st, ln, v, pn["attack_ms"], pn["decay_ms"], pn["sustain_level"],
            pn["release_ms"], pn["waveform_code"])
    got = TA.render_notes(*(torch.from_numpy(a) for a in args), sr, max_len,
                          total).numpy()
    ref = np.asarray(JA.render_notes(*(jnp.asarray(a) for a in args), sr=sr,
                                     max_len=max_len, total_samples=total))
    assert np.abs(got - ref).max() < 1e-5
    # a batch of scores renders as each score alone
    both = TA.render_notes(*(torch.from_numpy(np.stack([a, a[::-1]]))
                             for a in args), sr, max_len, total).numpy()
    assert np.abs(both[0] - got).max() == 0.0


@pytest.mark.parametrize("sr", [22050, 44100])
def test_effects_match_jax(sr):
    rng = np.random.default_rng(1)
    n = sr
    t = np.arange(n) / sr
    x = (0.6 * np.sin(2 * np.pi * 330 * t) * np.exp(-t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    X, J = torch.from_numpy(x), jnp.asarray(x)
    assert np.abs(TE.distortion(X, 0.8).numpy()
                  - np.asarray(JE.distortion(J, jnp.float32(0.8)))).max() < 1e-6
    for ms, fb in ((300.0, 0.3), (20.0, 0.9)):
        assert np.abs(TE.delay(X, ms, fb, sr).numpy()
                      - np.asarray(JE.delay(J, ms, fb, sr))).max() < 1e-6
    for room in (0.5, 0.7):
        assert np.abs(TE.reverb(X, room, sr).numpy()
                      - np.asarray(JE.reverb(J, room, sr))).max() < 1e-5


def _jax_lfo(n, rate, sr):
    """The JAX chorus's LFO (aegis_tpu/synth/effects.py, chorus)."""
    def f(rate):
        t = jnp.arange(n, dtype=jnp.float32)
        return jnp.sin(2.0 * jnp.pi * rate * t / sr)
    return np.array(jax.jit(f)(jnp.float32(rate)))


def _jax_source_indices(n, depth, rate, sr):
    def f(depth, rate):
        t = jnp.arange(n, dtype=jnp.float32)
        lfo = jnp.sin(2.0 * jnp.pi * rate * t / sr)
        idx = jnp.clip(t - (int(0.007 * sr) + depth * sr * lfo), 0, n - 1)
        return jnp.floor(idx).astype(jnp.int32)
    return np.asarray(jax.jit(f)(jnp.float32(depth), jnp.float32(rate)))


@pytest.mark.parametrize("sr", [22050, 44100])
@pytest.mark.parametrize("depth,rate", [(0.003, 1.5), (0.002, 1.5)])
def test_chorus_matches_jax(sr, depth, rate):
    """On the same LFO the port's chorus is JAX's: source samples equal and
    output within 1e-5.  The LFOs differ only where XLA's float32 sine is
    not the correctly rounded one, by one ulp (the port's is, so the card
    and the CPU agree)."""
    n = 2 * sr
    rng = np.random.default_rng(2)
    t = np.arange(n) / sr
    x = (0.6 * np.sin(2 * np.pi * 330 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    lfo_j = _jax_lfo(n, rate, sr)
    lfo_t = TE.chorus_lfo(n, rate, sr, CPU).numpy()
    ulps = np.abs(lfo_t.view(np.int32).astype(np.int64)
                  - lfo_j.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1 and (ulps > 0).mean() < 0.03

    ref = np.asarray(JE.chorus(jnp.asarray(x), jnp.float32(depth),
                               jnp.float32(rate), sr))
    on_jax_lfo = TE._chorus_mix(torch.from_numpy(x), torch.from_numpy(lfo_j),
                                depth, sr).numpy()
    assert np.abs(on_jax_lfo - ref).max() < 1e-5
    # the source samples on the same LFO: XLA contracts depth*sr*lfo + delay
    # into one fused multiply-add, and so does the port
    src = TE._chorus_indices(torch.from_numpy(lfo_j), depth, sr)
    np.testing.assert_array_equal(torch.floor(src).numpy().astype(np.int32),
                                  _jax_source_indices(n, depth, rate, sr))
    # with its own LFO the port's chorus stays near JAX's
    own = TE.chorus(torch.from_numpy(x), depth, rate, sr).numpy()
    assert np.abs(own - ref).max() < 1e-2


@pytest.mark.parametrize("preset", sorted(EFFECT_PRESETS))
def test_effect_presets_match_jax(preset, monkeypatch):
    """Every preset chain of the JAX package, on a rendered score; the
    chorus takes XLA's LFO here (see test_chorus_matches_jax)."""
    x = synthesize_note_arrays(_score(8), SR, device="cpu")
    monkeypatch.setattr(TE, "chorus_lfo", lambda n, rate, sr, device:
                        torch.from_numpy(_jax_lfo(n, rate, sr)).to(device))
    got = apply_effect_chain(x, EFFECT_PRESETS[preset], sr=SR, device="cpu")
    ref = np.asarray(JE.apply_effect_chain(x, EFFECT_PRESETS[preset], sr=SR))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5


def test_synthesize_midi_runs_the_adsr_synth_without_fluidsynth(
        monkeypatch, tmp_path):
    """The FluidSynth -> ADSR ladder of the copy: with no FluidSynth binary
    the port's ADSR synth renders, as the JAX package's does."""
    from aegis_tpu.synth import fluidsynth as jfs
    from aegis_tpu_torch.synth import fluidsynth as tfs

    monkeypatch.setenv("AEGIS_FLUIDSYNTH_BIN", str(tmp_path / "missing"))
    for mod in (tfs, jfs):
        monkeypatch.setattr(mod, "_singleton", None)
    assert not tfs.get_synthesizer().is_available()
    calls = []
    real = TA.synthesize_midi_adsr
    monkeypatch.setattr(TA, "synthesize_midi_adsr",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    midi = _simple_midi((55, 62))
    wav = tfs.synthesize_midi(midi, sample_rate=SR, device="cpu")
    assert calls and calls[0]["device"] == CPU
    _wav_close(wav, jfs.synthesize_midi(midi, sample_rate=SR))
    buf = io.BytesIO(wav)
    assert buf.getvalue()[:4] == b"RIFF"


def test_two_pi_and_reciprocal_constants():
    """The float32 constants XLA puts in the render program."""
    assert np.float32(TA._TWO_PI) == np.float32(6.28318548)
    assert np.float32(TA.ms_to_samples(44100)) == np.float32(44.1000023)
    assert np.float32(TA.ms_to_samples(22050)) == np.float32(22.0500011)
    assert np.float32(1.0 / 44100) == np.float32(2.26757365e-05)
    assert math.isclose(TA._INV_127, 0.00787401572, rel_tol=1e-8)
