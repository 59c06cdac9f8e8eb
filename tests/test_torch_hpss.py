"""HPSS of the port (aegis_tpu_torch/core/hpss.py) on the CPU against the JAX
package's program (aegis_tpu/core/hpss.py) and the float64 oracle, case for
case with tests/test_hpss.py; the stems wrapper, AegisEngine.separate_stems
and the ``stems`` command.

Tolerances (max abs): hpss_program 1e-4 against the oracle and the JAX
program; the wrapper at a non-bucket length against an exact-length run and
the slab mode against the unsliced run 5e-5; the iSTFT(STFT) round trip
1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aegis_tpu.core import hpss as JH
from aegis_tpu.ref.hpss_ref import hpss_ref
from aegis_tpu_torch.core import hpss as TH
from aegis_tpu_torch.core.analyze import quantize_pcm16

SR = 22050
REPO = Path(__file__).resolve().parents[1]


def _mix(dur=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * dur)) / SR
    tone = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.25 * np.sin(2 * np.pi * 440 * t)
    clicks = np.zeros_like(t)
    for c in np.arange(0.1, dur - 0.05, 0.15):
        k = int(c * SR)
        clicks[k:k + 80] += rng.standard_normal(80) * 0.6
    return (tone + clicks).astype(np.float32), tone, clicks


def test_istft_roundtrip_exact():
    t = np.arange(8192) / SR
    y = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    r, i = TH.stft_complex(torch.from_numpy(y), 2048, 512)
    rec = TH.istft(r, i, 2048, 512, len(y)).numpy()
    assert np.abs(rec - y).max() < 1e-5
    # the spectrum against JAX's, within 1e-6 of its peak magnitude
    for got, ref in zip((r, i), JH.stft_complex(jnp.asarray(y), 2048, 512)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() < 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("size", [17, 5])
def test_median_along_equals_jax(axis, size):
    """Edge-replicated running median of an odd window: the exact middle
    element, the value jnp.median picks (ties included)."""
    rng = np.random.default_rng(size + axis)
    x = rng.random((40, 33)).astype(np.float32)
    x[5:9] = 0.5                      # runs of equal values
    got = TH._median_along(torch.from_numpy(x), size, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        JH._median_along(jnp.asarray(x), size, axis)))


def test_hpss_program_matches_oracle_and_jax():
    y, _, _ = _mix()
    out = TH.hpss_program(y, length=len(y), device="cpu").numpy()
    yh_r, yp_r = hpss_ref(y)
    assert np.abs(out[0] - yh_r).max() < 1e-4
    assert np.abs(out[1] - yp_r).max() < 1e-4
    j = np.asarray(JH.hpss_program(jnp.asarray(y), length=len(y)))
    assert np.abs(out - j).max() < 1e-4


def test_hpss_wrapper_exact_at_any_length():
    """The bucket-padded wrapper equals an exact-length program run at every
    sample, including the last frames, whose time-median context is the
    replicated last real frame rather than the bucket's zero tail."""
    y, _, _ = _mix(1.37, seed=3)  # length far off any bucket edge
    yh, yp = TH.hpss(y, device="cpu")
    y16, s = quantize_pcm16(y)  # the wrapper's int16 transport, replayed
    yq = y16.astype(np.float32) * s
    exact = TH.hpss_program(yq, length=len(y), device="cpu").numpy()
    assert np.abs(yh - exact[0]).max() < 5e-5
    assert np.abs(yp - exact[1]).max() < 5e-5
    yh_r, yp_r = hpss_ref(yq)
    tail = slice(len(y) - 10 * 512, len(y))
    assert np.abs(yh[tail] - yh_r[tail]).max() < 1e-4
    assert np.abs(yp[tail] - yp_r[tail]).max() < 1e-4
    jh, jp = JH.hpss(y)
    assert np.abs(yh - jh).max() < 5e-5
    assert np.abs(yp - jp).max() < 5e-5


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (1800, 600)],
                         ids=["hop512", "hop600"])
def test_hpss_slab_mode_matches_unsliced(monkeypatch, n_fft, hop):
    """Force the slab path on a short mix: it equals the one-shot program
    (one track-global int16 scale, hop-aligned slab starts), at a hop that
    is a power of two and one that is not."""
    y, _, _ = _mix(2.0)
    yh1, yp1 = TH.hpss(y, n_fft=n_fft, hop_length=hop, device="cpu")
    monkeypatch.setattr(TH, "_SLAB_SAMPLES", 1 << 15)  # ~1.5 s -> slabs
    yh2, yp2 = TH.hpss(y, n_fft=n_fft, hop_length=hop, device="cpu")
    assert np.abs(yh1 - yh2).max() < 5e-5
    assert np.abs(yp1 - yp2).max() < 5e-5


def test_hpss_separates_tone_from_clicks():
    y, tone, clicks = _mix()
    yh, yp = TH.hpss(y, device="cpu")
    assert np.corrcoef(yh, tone)[0, 1] > 0.95
    assert np.corrcoef(yp, clicks)[0, 1] > 0.7
    assert abs((yh + yp).mean() - y.mean()) < 0.05


def test_separate_stems_hpss_fallback(tmp_path, monkeypatch):
    from aegis_tpu.synth import stems as jstems
    from aegis_tpu_torch.io.wav import read_wav, write_wav
    from aegis_tpu_torch.synth import stems

    y, _, _ = _mix(0.5)
    src = str(tmp_path / "in.wav")
    write_wav(src, y, SR)

    monkeypatch.setattr(stems, "find_demucs", lambda: None)
    out = stems.separate_stems(src, str(tmp_path), method="auto",
                               device="cpu")
    assert out != src and out.endswith("other.wav") and os.path.exists(out)
    assert os.path.exists(os.path.join(os.path.dirname(out), "drums.wav"))

    forced = stems.separate_stems(src, str(tmp_path / "f"), method="hpss",
                                  device="cpu")
    assert forced.endswith("other.wav")

    yh, sr2 = read_wav(out)
    assert sr2 == SR and len(yh) == len(y)
    # the JAX package's stems, one int16 step apart at most
    monkeypatch.setattr(jstems, "find_demucs", lambda: None)
    j_out = jstems.separate_stems(src, str(tmp_path / "j"), method="auto")
    for name in ("other.wav", "drums.wav"):
        a, _ = read_wav(os.path.join(os.path.dirname(out), name))
        b, _ = read_wav(os.path.join(os.path.dirname(j_out), name))
        assert np.abs(a - b).max() <= 1.0 / 32767 + 1e-9, name


def test_separate_stems_raises_where_the_reference_falls_back(tmp_path,
                                                            monkeypatch):
    """No fallback hides the device: an HPSS error raises through
    method="auto" (the JAX package returns the original mix instead)."""
    from aegis_tpu_torch.core import hpss as hmod
    from aegis_tpu_torch.io.wav import write_wav
    from aegis_tpu_torch.synth import stems

    src = str(tmp_path / "in.wav")
    write_wav(src, _mix(0.5)[0], SR)
    monkeypatch.setattr(stems, "find_demucs", lambda: None)

    def broken(*a, **k):
        raise RuntimeError("device failure")

    monkeypatch.setattr(hmod, "hpss", broken)
    with pytest.raises(RuntimeError, match="device failure"):
        stems.separate_stems(src, str(tmp_path), method="auto", device="cpu")
    # a missing Demucs is no device error: the forced method returns the mix
    assert stems.separate_stems(src, str(tmp_path), method="demucs",
                                device="cpu") == src


def test_engine_separate_stems_and_cli(tmp_path, monkeypatch):
    from aegis_tpu_torch.engine.engine import AegisEngine
    from aegis_tpu_torch.io.wav import read_wav, write_wav
    from aegis_tpu_torch.synth import stems

    y, _, _ = _mix(0.7, seed=5)
    src = str(tmp_path / "mix.wav")
    write_wav(src, y, SR)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "PATH": os.defpath, "AEGIS_DEMUCS_BIN": ""}
    monkeypatch.setattr(stems, "find_demucs", lambda: None)
    out = AegisEngine(sample_rate=SR, device="cpu").separate_stems(
        src, str(tmp_path / "eng"))
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "stems", src,
         str(tmp_path / "cli"), "--method", "hpss", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip().splitlines()[-1]
    assert path.endswith(os.path.join("hpss", "mix", "other.wav"))
    assert os.path.exists(os.path.join(os.path.dirname(path), "drums.wav"))
    a, _ = read_wav(out)
    b, _ = read_wav(path)
    # one thread in the command, several here: another matmul order
    assert np.abs(a - b).max() <= 1.0 / 32767 + 1e-9
    # demucs forced where there is none: the input comes back, exit code 2
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "stems", src,
         str(tmp_path / "d"), "--method", "demucs", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == src

