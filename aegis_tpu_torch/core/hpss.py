"""Harmonic/percussive source separation (HPSS) on the device (PyTorch).

Counterpart of ``aegis_tpu/core/hpss.py`` (Fitzgerald 2010, the
librosa.effects.hpss family): a median filter along time enhances the
harmonic ridges of the magnitude spectrogram, one along frequency the
percussive columns, and soft Wiener masks split the complex STFT.

The same formulation as the JAX program:

  * STFT and iSTFT are matmul-DFTs against ``core/filters.dft_matrices`` and
    ``_idft_matrices``, frames from ``core/dsp.frame_signal`` on constant
    (zero) padding.
  * The overlap-add inverse is ``n_fft / hop`` statically shifted
    contiguous adds, in that order (slice ``+=``).  No ``index_add_`` or
    ``F.fold``: CUDA atomics would reorder the sum.
  * Each running median is an edge-replicated ``unfold`` of the odd window
    reduced by ``median``; for an odd window that is the exact middle
    element, the value ``jnp.median`` picks.

NumPy oracle: ``ref/hpss_ref.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.core.analyze import pad_to_bucket, quantize_pcm16
from aegis_tpu_torch.core.dsp import frame_signal
from aegis_tpu_torch.core.filters import dft_matrices, hann_window


def _idft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse one-sided DFT as matmul operands: frame = R @ icos - I @ isin
    with shapes (n_bins, n_fft).  Interior bins carry the
    conjugate-symmetry factor 2."""
    n_bins = 1 + n_fft // 2
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    icos = (w * np.cos(ang) / n_fft).astype(np.float32)
    isin = (w * np.sin(ang) / n_fft).astype(np.float32)
    return icos, isin


@dataclasses.dataclass(frozen=True)
class HpssTables:
    window: torch.Tensor   # (n_fft,) periodic Hann
    cos: torch.Tensor      # (n_fft, n_bins)
    nsin: torch.Tensor     # (n_fft, n_bins), -sin
    icos: torch.Tensor     # (n_bins, n_fft)
    isin: torch.Tensor     # (n_bins, n_fft)
    win2: np.ndarray       # (n_fft,) float32 window squared, host


@functools.lru_cache(maxsize=8)
def hpss_tables(n_fft: int, device: torch.device) -> HpssTables:
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    cos, nsin = dft_matrices(n_fft)
    icos, isin = _idft_matrices(n_fft)
    win = hann_window(n_fft)
    return HpssTables(window=dev(win), cos=dev(cos), nsin=dev(nsin),
                      icos=dev(icos), isin=dev(isin),
                      win2=(win * win).astype(np.float32))


def stft_complex(y: torch.Tensor, n_fft: int, hop_length: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered Hann STFT on constant padding as (real, imag), each
    (T, 1+n_fft//2)."""
    tab = hpss_tables(n_fft, y.device)
    fw = frame_signal(y, n_fft, hop_length, "constant") * tab.window[None, :]
    return fw @ tab.cos, fw @ tab.nsin


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Sum of the (T, n_fft) frames placed hop_length apart, as n_fft/hop
    shifted contiguous adds in a fixed order; length T*hop + n_fft."""
    T, n_fft = frames.shape
    out = torch.zeros(T * hop_length + n_fft, dtype=frames.dtype,
                      device=frames.device)
    for j in range(n_fft // hop_length):
        out[j * hop_length: j * hop_length + T * hop_length] += \
            frames[:, j * hop_length:(j + 1) * hop_length].reshape(-1)
    return out


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int,
          hop_length: int, length: int,
          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse STFT with Hann synthesis window and window-sum-square
    normalization, scatter-free overlap-add (requires hop | n_fft).

    ``valid`` (optional (T,) float 0/1 mask) restricts both the signal
    accumulation and the window sum to the first ``sum(valid)`` frames; the
    window sum is then accumulated on the device with the same shifted adds,
    else it is the host's."""
    if n_fft % hop_length:
        raise ValueError(f"istft needs hop | n_fft, got {hop_length}, {n_fft}")
    tab = hpss_tables(n_fft, real.device)
    frames = (real @ tab.icos - imag @ tab.isin) * tab.window[None, :]
    if valid is not None:
        frames = frames * valid[:, None]
    T = frames.shape[0]
    pad = n_fft // 2  # centered framing offset
    out = _overlap_add(frames, hop_length)

    if valid is None:
        out_len = T * hop_length + n_fft
        wss_np = np.zeros(out_len, np.float32)
        for t in range(T):
            wss_np[t * hop_length: t * hop_length + n_fft] += tab.win2
        wss = torch.from_numpy(np.maximum(wss_np, 1e-8)).to(out.device)
    else:
        w2 = torch.from_numpy(tab.win2).to(out.device)
        wss = torch.clamp_min(_overlap_add(valid[:, None] * w2[None, :],
                                           hop_length), 1e-8)
    out = out / wss
    return out[pad: pad + length]


def _median_along(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Running median of odd window ``size`` along ``axis`` of a 2-D
    tensor, edge-padded."""
    half = size // 2
    xt = x.T if axis == 0 else x          # the filtered axis last
    xp = F.pad(xt[None], (half, half), mode="replicate")[0]
    med = xp.unfold(-1, size, 1).median(dim=-1).values
    return med.T if axis == 0 else med


def hpss_program(y, n_fft: int = 2048, hop_length: int = 512,
                 kernel_time: int = 17, kernel_freq: int = 17,
                 power: float = 2.0, length: Optional[int] = None,
                 n_frames: Optional[int] = None, device="cuda"
                 ) -> torch.Tensor:
    """STFT -> dual median filters -> soft masks -> two iSTFTs on ``device``.
    Returns the (2, length) stack of the harmonic and percussive waveforms.

    ``n_frames`` (optional host int) marks how many leading STFT frames are
    real audio: frames past it are replaced by the last real frame inside
    the time median and left out of the overlap-add, so a bucket-padded
    call gives the output of an exact-length run on those frames."""
    dev = resolve_device(device)
    y = (y.to(device=dev, dtype=torch.float32) if torch.is_tensor(y)
         else torch.from_numpy(np.array(y, np.float32)).to(dev))
    n = length if length is not None else y.shape[0]
    real, imag = stft_complex(y, n_fft, hop_length)
    S = torch.sqrt(real * real + imag * imag)  # (T, F) magnitude

    valid = None
    if n_frames is not None:
        T = S.shape[0]
        last = min(max(n_frames - 1, 0), T - 1)
        keep = torch.arange(T, device=dev) < n_frames
        S = torch.where(keep[:, None], S, S[last][None, :])
        valid = keep.to(torch.float32)

    H = _median_along(S, kernel_time, axis=0)   # harmonic: smooth in time
    P = _median_along(S, kernel_freq, axis=1)   # percussive: smooth in freq
    Hp = H ** power
    Pp = P ** power
    denom = Hp + Pp + 1e-10
    mh = Hp / denom
    mp = Pp / denom

    y_h = istft(real * mh, imag * mh, n_fft, hop_length, n, valid)
    y_p = istft(real * mp, imag * mp, n_fft, hop_length, n, valid)
    return torch.stack([y_h, y_p])


# Above this many samples the program's (T, F, kernel) median stacks get
# large (~17x the spectrogram); process in exact overlapping slabs.
_SLAB_SAMPLES = 1 << 21  # ~95 s @ 22050


def hpss(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512,
         kernel_time: int = 17, kernel_freq: int = 17, power: float = 2.0,
         device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: bucket pad, one track-global int16 scale, one packed
    (2, n) fetch a program.

    The true frame count rides into the program as ``n_frames``, so the
    bucket's zero tail never reaches the time median or the overlap-add.
    Tracks longer than ``_SLAB_SAMPLES`` run as overlapping slabs with a
    halo of (kernel_time//2)*hop + 2*n_fft samples (a kept sample depends on
    frames within n_fft/hop of it, whose median context reaches
    kernel_time//2 frames further, whose windows reach n_fft/2 further
    still); slab starts are hop-aligned, so every kept sample sees the
    unsliced program's median context, window sum and quantization."""
    dev = resolve_device(device)
    y = np.asarray(y, np.float32)
    n = len(y)
    y16_full, scale = quantize_pcm16(y)

    def run(seg16: np.ndarray) -> np.ndarray:
        true_len = len(seg16)
        seg_pad = pad_to_bucket(seg16)
        y_dev = (torch.from_numpy(seg_pad).to(dev).to(torch.float32)
                 * np.float32(scale))
        hp = hpss_program(y_dev, n_fft, hop_length, kernel_time, kernel_freq,
                          power, length=len(seg_pad),
                          n_frames=1 + true_len // hop_length, device=dev)
        return hp[:, :true_len].cpu().numpy()

    if n <= _SLAB_SAMPLES:
        out = run(y16_full)
        return out[0][:n], out[1][:n]

    halo = (kernel_time // 2) * hop_length + 2 * n_fft
    step = ((_SLAB_SAMPLES - 2 * halo) // hop_length) * hop_length
    parts = []
    for start in range(0, n, step):
        a = max(start - halo, 0)
        b = min(start + step + halo, n)
        seg_out = run(y16_full[a:b])
        keep_lo = start - a
        keep_hi = keep_lo + min(step, n - start)
        parts.append(seg_out[:, keep_lo:keep_hi])
    out = np.concatenate(parts, axis=1)
    return out[0][:n], out[1][:n]
