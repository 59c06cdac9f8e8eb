"""Audio effect chain as PyTorch device ops.

Counterpart of ``aegis_tpu/synth/effects.py`` (itself a fixed-shape mirror of
the reference's NumPy effects, effect_learning_loop.py:56-275):

  * distortion — tanh soft clipping with drive->gain mapping
  * reverb — convolution with a seeded exponential-decay IR as an FFT
    product (``torch.fft``)
  * delay — the feedforward echo sum (gain = feedback**i, up to 20 echoes or
    gain < 0.01) as shifted adds in echo order
  * chorus — LFO-modulated fractional delay with linear interpolation

All effects normalize to <= 1.0 peak like the reference.  The IR's random
diffusion is host NumPy with the seed 42.

The scalars the JAX program computes on the device in float32 (the
distortion gain, the echo gains, the LFO's rate and depth factors) are
computed here in float32 on the host, as XLA does, and the LFO's ``t / sr``
is a product with the float32 reciprocal.  The LFO itself is a float64 sine
rounded to float32, so the card and the CPU pick the same source sample in
``floor(indices)``; XLA's float32 sine is 1 ulp off that on about 1 % of
the samples.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.synth.presets import EFFECT_PRESETS  # noqa: F401 (re-export)


def _limit(x: torch.Tensor) -> torch.Tensor:
    peak = torch.amax(torch.abs(x))
    return torch.where(peak > 1.0, x / peak, x)


def distortion(audio: torch.Tensor, drive: float) -> torch.Tensor:
    gain = np.float32(1.0) + np.float32(drive) * np.float32(19.0)
    d = torch.tanh(audio * float(gain))
    d = d / torch.clamp_min(torch.amax(torch.abs(d)), 1e-6)
    return torch.clamp(d, -1.0, 1.0)


def _reverb_ir(room_size: float, sr: int) -> np.ndarray:
    duration = room_size * 3.0
    ir_length = int(sr * duration)
    if ir_length <= 0:
        return np.zeros(0, np.float32)
    t = np.arange(ir_length, dtype=np.float64)
    decay_rate = 5.0 / max(duration, 0.01)
    ir = np.exp(-decay_rate * t / sr)
    rng = np.random.RandomState(42)
    ir *= rng.uniform(0.8, 1.0, size=ir_length)
    ir /= max(np.sum(np.abs(ir)), 1e-6)
    return ir.astype(np.float32)


def _fft_convolve_head(audio: torch.Tensor, ir: torch.Tensor,
                       n_fft: int) -> torch.Tensor:
    A = torch.fft.rfft(audio, n_fft)
    B = torch.fft.rfft(ir, n_fft)
    return torch.fft.irfft(A * B, n_fft)[: audio.shape[0]]


def reverb(audio: torch.Tensor, room_size: float = 0.5,
           sr: int = 44100) -> torch.Tensor:
    ir = _reverb_ir(room_size, sr)
    if len(ir) == 0:
        return audio
    n = int(audio.shape[0])
    n_fft = 1
    while n_fft < n + len(ir):
        n_fft <<= 1
    wet = _fft_convolve_head(audio, torch.from_numpy(ir).to(audio.device),
                             n_fft)
    wet_ratio = room_size * 0.6
    dry_ratio = 1.0 - wet_ratio * 0.5
    return _limit(dry_ratio * audio + wet_ratio * wet)


def _f32_pow(x: np.float32, i: int) -> np.float32:
    """x**i in float32 by binary exponentiation, the multiplications
    ``jax.lax.integer_pow`` makes."""
    acc = None
    while i > 0:
        if i & 1:
            acc = x if acc is None else np.float32(acc * x)
        i >>= 1
        if i > 0:
            x = np.float32(x * x)
    return acc


def _delay_sum(audio: torch.Tensor, feedback: np.float32, delay_samples: int,
               n_echoes: int) -> torch.Tensor:
    n = audio.shape[0]
    out = audio
    for i in range(1, n_echoes + 1):
        offset = delay_samples * i
        if offset >= n:
            break
        gain = float(_f32_pow(feedback, i))
        out = torch.cat([out[:offset], out[offset:] + audio[: n - offset] * gain])
    return _limit(out)


def delay(audio: torch.Tensor, delay_ms: float = 300.0, feedback: float = 0.3,
          sr: int = 44100) -> torch.Tensor:
    delay_samples = int(delay_ms / 1000.0 * sr)
    if delay_samples <= 0 or feedback <= 0:
        return audio
    # feedback >= 1 would never decay below the -40 dB echo cutoff; clamp to
    # a stable loop and let the 20-echo cap bound the tail
    feedback = min(float(feedback), 0.99)
    n_echoes = min(int(np.log(0.01) / np.log(max(feedback, 0.01))), 20)
    # echoes with gain < 0.01 are dropped (the reference's early break)
    n_echoes = max(1, min(n_echoes,
                          int(np.ceil(audio.shape[0] / delay_samples))))
    return _delay_sum(audio, np.float32(feedback), delay_samples, n_echoes)


def chorus_lfo(n: int, rate: float, sr: int, device) -> torch.Tensor:
    """(n,) float32 LFO of the chorus, sin(2 pi rate t / sr): the argument
    as XLA computes it in float32, the sine in float64 rounded to float32."""
    t = torch.arange(n, dtype=torch.float32, device=device)
    rate_w = np.float32(rate) * np.float32(2.0 * math.pi)
    arg = t * float(rate_w) * float(np.float32(1.0 / sr))
    return torch.sin(arg.to(torch.float64)).to(torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once: XLA's CPU code contracts the chorus's
    multiply-adds into fused multiply-adds.  Computed in float64, where the
    product of two float32 values is exact, on the CPU and the card alike."""
    b = b.to(torch.float64) if torch.is_tensor(b) else float(b)
    c = c.to(torch.float64) if torch.is_tensor(c) else float(c)
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _chorus_indices(lfo: torch.Tensor, depth: float, sr: int) -> torch.Tensor:
    """Fractional source position of each sample: a delay of 7 ms +
    depth * lfo seconds."""
    n = lfo.shape[0]
    t = torch.arange(n, dtype=torch.float32, device=lfo.device)
    depth_sr = np.float32(depth) * np.float32(sr)
    return torch.clamp(t - _fma(lfo, depth_sr, int(0.007 * sr)), 0, n - 1)


def _chorus_mix(audio: torch.Tensor, lfo: torch.Tensor, depth: float,
                sr: int) -> torch.Tensor:
    """The chorus on a given LFO: linear interpolation between the two
    source samples of each fractional position."""
    n = audio.shape[0]
    indices = _chorus_indices(lfo, depth, sr)
    lo = torch.floor(indices).to(torch.int64)
    hi = torch.clamp_max(lo + 1, n - 1)
    frac = indices - lo.to(torch.float32)
    wet = _fma(audio[lo], 1.0 - frac, audio[hi] * frac)
    return _limit(_fma(audio, np.float32(0.7), wet * 0.3))


def chorus(audio: torch.Tensor, depth: float = 0.003, rate: float = 1.5,
           sr: int = 44100) -> torch.Tensor:
    return _chorus_mix(audio, chorus_lfo(audio.shape[0], rate, sr,
                                         audio.device), depth, sr)


def apply_effect_chain(audio: np.ndarray, effects_config: List[Tuple[str, dict]],
                       sr: int = 44100, device="cuda") -> np.ndarray:
    """Chain effects in order on ``device``; unknown names are skipped
    (reference effect_learning_loop.py:234-275)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.array(audio, np.float32)).to(dev)
    for name, params in effects_config:
        if name == "distortion":
            x = distortion(x, params.get("drive", 0.5))
        elif name == "reverb":
            x = reverb(x, float(params.get("room_size", 0.5)), sr)
        elif name == "delay":
            x = delay(x, float(params.get("delay_ms", 300)),
                      float(params.get("feedback", 0.3)), sr)
        elif name == "chorus":
            x = chorus(x, params.get("depth", 0.003),
                       params.get("rate", 1.5), sr)
    return x.cpu().numpy()
