"""ADSR software synthesizer — batched PyTorch formulation.

Counterpart of ``aegis_tpu/synth/adsr.py``.  The whole score is one batch of
tensors on the device:

  * notes are tensors (freq, start, length, velocity, per-note ADSR params,
    per-note waveform code); every leading batch dimension renders at once,
    which is what the auto-match and per-note sweeps use;
  * each note renders into a fixed (max_len,) row of an (..., N, max_len)
    tensor: closed-form piecewise ADSR envelope, branchless 4-waveform
    oscillator, 2nd-5th harmonics at 0.5/0.25/0.125/0.0625 under the
    Nyquist guard, per-note peak normalization;
  * the mixdown shifts each note into block alignment and sums the blocks
    with a one-hot matmul (a fixed-order sum, no scatter-add), then
    normalizes to a 0.9 peak.

XLA evaluates a division by a constant as a product with the float32
reciprocal, and folds ``sr * x / 1000`` into ``x * (f32(sr) * f32(0.001))``.
The phase ``(freq * t) % 1`` carries any last-bit difference of ``t`` into a
note that runs thousands of cycles, and the envelope floors its segment
lengths, so both are built here the way XLA computes them.

Host wrappers parse SMF bytes into note arrays and emit WAV bytes.
"""

from __future__ import annotations

import io
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.io.wav import write_wav
from aegis_tpu_torch.midi.decode import midi_to_notes
from aegis_tpu_torch.synth.presets import GUITAR_ADSR_PRESETS, WAVEFORM_CODES

_HARMONIC_AMPS = (0.5, 0.25, 0.125, 0.0625)  # 2nd..5th
_TWO_PI = 2.0 * math.pi
_INV_127 = float(np.float32(1.0 / 127.0))


def ms_to_samples(sr: int) -> float:
    """The float32 factor XLA multiplies milliseconds by for
    ``sr * ms / 1000.0``."""
    return float(np.float32(sr) * np.float32(0.001))


def segment_lengths(attack_ms: torch.Tensor, decay_ms: torch.Tensor,
                    release_ms: torch.Tensor, sr: int):
    """Attack, decay and release lengths in whole samples (float tensors)."""
    c = ms_to_samples(sr)
    return (torch.floor(attack_ms * c), torch.floor(decay_ms * c),
            torch.floor(release_ms * c))


def _oscillator(phase: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Branchless waveform select.  phase = (freq * t) mod 1."""
    sine = torch.sin(phase * _TWO_PI)
    saw = 2.0 * phase - 1.0
    square = torch.sign(sine)
    triangle = 2.0 * torch.abs(saw) - 1.0
    return torch.where(code == 0, sine,
                       torch.where(code == 1, saw,
                                   torch.where(code == 2, square, triangle)))


def _envelope(k: torch.Tensor, n: torch.Tensor, sr: int,
              attack_ms: torch.Tensor, decay_ms: torch.Tensor,
              sustain: torch.Tensor, release_ms: torch.Tensor) -> torch.Tensor:
    """Closed-form ADSR at sample index k for an n-sample note (the note
    parameters broadcast against k)."""
    a, d, r = segment_lengths(attack_ms, decay_ms, release_ms, sr)
    s_len = torch.clamp_min(n - a - d - r, 0.0)

    in_attack = k < a
    in_decay = k < a + d
    in_sustain = k < a + d + s_len
    in_release = k < a + d + s_len + r

    attack_v = k / torch.clamp_min(a, 1.0)
    decay_v = 1.0 + (sustain - 1.0) * (k - a) / torch.clamp_min(d, 1.0)
    rel_j = k - a - d - s_len
    release_v = sustain * (1.0 - rel_j / torch.clamp_min(r - 1.0, 1.0))

    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    env = torch.where(
        in_attack, attack_v,
        torch.where(in_decay, decay_v,
                    torch.where(in_sustain, sustain,
                                torch.where(in_release, release_v, zero))))
    # a select, not a product with the mask: XLA makes ``* (k < n)`` one,
    # which gives +0 past the note where a product gives -0 for a negative
    # value (the per-note zero-crossing rate counts signbit flips)
    return torch.where(k < n, torch.clamp(env, 0.0, 1.0), zero)


def render_note_buffers(freqs, lengths, velocities, attack_ms, decay_ms,
                        sustain, release_ms, wave_codes, sr: int,
                        max_len: int) -> torch.Tensor:
    """Every note into a (max_len,) row, zero beyond its length: (..., N)
    float tensors (``wave_codes`` int) -> (..., N, max_len)."""
    def col(x):
        return x[..., None]

    inv_sr = np.float32(1.0 / sr)
    k = torch.arange(max_len, dtype=torch.float32, device=freqs.device)
    t = k * float(inv_sr)
    n = col(lengths.to(torch.float32))
    active = k < n
    freq, code = col(freqs), col(wave_codes)

    def phase(h: float) -> torch.Tensor:
        """(freq * h * t) mod 1.  Where the whole batch is one note, XLA
        reassociates the product into k * (freq * f32(h / sr))."""
        if freqs.numel() == 1:
            hc = float(inv_sr) if h == 1.0 else float(np.float32(h) * inv_sr)
            return torch.fmod(k * (freq * hc), 1.0)
        return torch.fmod((freq * h if h != 1.0 else freq) * t, 1.0)

    sig = _oscillator(phase(1.0), code)
    nyquist = sr / 2.0
    zero = torch.zeros((), dtype=torch.float32, device=freqs.device)
    for i, amp in enumerate(_HARMONIC_AMPS):
        h = float(i + 2)
        gain = torch.where(col(freqs * h) < nyquist, amp, zero)
        sig = sig + gain * _oscillator(phase(h), code)
    peak = torch.amax(torch.abs(sig * active), dim=-1, keepdim=True)
    sig = sig / torch.clamp_min(peak, 1e-9)

    env = _envelope(k, n, sr, col(attack_ms), col(decay_ms), col(sustain),
                    col(release_ms))
    return torch.where(active, sig * env, zero) * col(
        torch.clamp(velocities * _INV_127, 0.0, 1.0))


def render_notes(freqs, starts, lengths, velocities, attack_ms, decay_ms,
                 sustain, release_ms, wave_codes, sr: int, max_len: int,
                 total_samples: int) -> torch.Tensor:
    """Whole-score synthesis of (..., N) note tensors -> (..., total_samples):
    the batched note render, then the block-aligned mixdown, normalized to a
    0.9 peak.  Each note spans at most two max_len-sized blocks; it is
    shifted into block alignment by one gather and the blocks are summed by
    a one-hot matmul."""
    buffers = render_note_buffers(freqs, lengths, velocities, attack_ms,
                                  decay_ms, sustain, release_ms, wave_codes,
                                  sr, max_len)
    blk = max_len
    lead = buffers.shape[:-2]
    n = buffers.shape[-2]
    n_blocks = max(-(-total_samples // blk), 1)
    starts = starts.to(torch.int64)
    rem = starts % blk
    b0 = starts // blk

    zeros = buffers.new_zeros(buffers.shape)
    padded = torch.cat([zeros, buffers, zeros], dim=-1)       # (..., N, 3 blk)
    idx = (blk - rem)[..., None] + torch.arange(2 * blk, device=rem.device)
    aligned = torch.gather(padded, -1, idx)                   # (..., N, 2 blk)

    rows = aligned.reshape(*lead, 2 * n, blk)
    bids = torch.stack([b0, b0 + 1], dim=-1).reshape(*lead, 2 * n)
    keep = (bids < n_blocks).to(torch.float32)
    bids = torch.clamp_max(bids, n_blocks - 1)
    onehot = F.one_hot(bids, n_blocks).to(torch.float32)     # (..., 2N, nb)
    mixed = onehot.transpose(-1, -2) @ (rows * keep[..., None])
    mixed = mixed.reshape(*lead, n_blocks * blk)[..., :total_samples]

    peak = torch.amax(torch.abs(mixed), dim=-1, keepdim=True)
    return mixed / torch.clamp_min(peak, 1e-9) * 0.9


def _pow2(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def synthesize_note_arrays(
    notes: list, sr: int,
    attack_ms=10.0, decay_ms=50.0, sustain_level=0.7, release_ms=100.0,
    waveform: str = "sawtooth",
    per_note: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
) -> np.ndarray:
    """Render a note list [{note, start, end, velocity}] (seconds) to audio
    on ``device``.

    ``per_note`` may carry arrays overriding any of attack_ms/decay_ms/
    sustain_level/release_ms/waveform_code per note.
    """
    dev = resolve_device(device)
    if not notes:
        return np.zeros(int(sr * 0.5), np.float32)
    N = len(notes)

    def arr(key, default):
        if per_note and key in per_note:
            return np.asarray(per_note[key], np.float32)
        return np.full(N, default, np.float32)

    freqs = np.array([440.0 * 2 ** ((n["note"] - 69) / 12.0) for n in notes],
                     np.float32)
    starts = np.array([int(n["start"] * sr) for n in notes], np.int32)
    rel = arr("release_ms", release_ms)
    durs = np.array(
        [max(0.01, n["end"] - n["start"]) for n in notes], np.float32
    ) + rel / 1000.0
    lengths = (durs * sr).astype(np.int32)
    velocities = np.array([n.get("velocity", 100) for n in notes], np.float32)

    if per_note and "waveform_code" in per_note:
        codes = np.asarray(per_note["waveform_code"], np.int32)
    else:
        codes = np.full(N, WAVEFORM_CODES.get(waveform, 1), np.int32)

    end_time = max(n["end"] for n in notes) + float(np.max(rel)) / 1000.0 + 0.5
    total = _pow2(int(end_time * sr))
    max_len = _pow2(int(np.max(lengths)) + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = render_notes(
        t(freqs), t(starts), t(lengths), t(velocities),
        t(arr("attack_ms", attack_ms)), t(arr("decay_ms", decay_ms)),
        t(arr("sustain_level", sustain_level)), t(rel), t(codes),
        sr=sr, max_len=max_len, total_samples=total,
    )
    return out[: int(end_time * sr)].cpu().numpy()


def midi_to_wav_adsr(midi_data, attack_ms=10.0, decay_ms=50.0,
                     sustain_level=0.7, release_ms=100.0,
                     waveform: str = "sawtooth", sample_rate: int = 44100,
                     device="cuda") -> bytes:
    """SMF bytes -> WAV bytes through the batched ADSR synth."""
    notes = midi_to_notes(midi_data)
    audio = synthesize_note_arrays(
        notes, sample_rate, attack_ms=attack_ms, decay_ms=decay_ms,
        sustain_level=sustain_level, release_ms=release_ms, waveform=waveform,
        device=device,
    )
    buf = io.BytesIO()
    write_wav(buf, audio, sample_rate)
    return buf.getvalue()


def synthesize_midi_adsr(midi_data, preset: str = "electric_clean",
                         sample_rate: int = 44100, device="cuda",
                         **adsr_overrides) -> bytes:
    """Preset-based convenience entry (reference synthesizer.py:642-699)."""
    params = dict(GUITAR_ADSR_PRESETS.get(preset,
                                          GUITAR_ADSR_PRESETS["electric_clean"]))
    params.update(adsr_overrides)
    return midi_to_wav_adsr(
        midi_data,
        attack_ms=params.get("attack_ms", 10),
        decay_ms=params.get("decay_ms", 50),
        sustain_level=params.get("sustain_level", 0.7),
        release_ms=params.get("release_ms", 100),
        waveform=params.get("waveform", "sawtooth"),
        sample_rate=sample_rate,
        device=device,
    )


# --------------------------------------------------------------------------
# Envelope analysis (host): estimate ADSR params from real audio
# (reference synthesizer.py:512-627); a copy of the JAX package's
# --------------------------------------------------------------------------

def analyze_envelope(audio_data: np.ndarray, sr: int = 44100) -> Dict[str, float]:
    audio = np.asarray(audio_data)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float64) / 32768.0
    if audio.ndim == 2:
        audio = audio.mean(axis=1)

    frame = int(sr * 0.005)
    hop = max(frame // 2, 1)
    n_frames = max(1, (len(audio) - frame) // hop + 1)
    if n_frames < 1 or len(audio) < frame:
        return {"attack_ms": 10.0, "decay_ms": 50.0, "sustain_level": 0.7,
                "release_ms": 100.0}
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    idx = np.minimum(idx, len(audio) - 1)
    rms = np.sqrt(np.mean(audio[idx] ** 2, axis=1))
    if rms.max() == 0:
        return {"attack_ms": 10.0, "decay_ms": 50.0, "sustain_level": 0.7,
                "release_ms": 100.0}
    rms_n = rms / rms.max()

    peak = int(np.argmax(rms_n))
    attack_ms = max(1, peak) * hop / sr * 1000.0

    total = len(rms_n)
    if peak < total - 1:
        s0 = peak + max(1, int((total - peak) * 0.2))
        s1 = min(peak + max(2, int((total - peak) * 0.7)), total)
        sustain = float(np.mean(rms_n[s0:s1])) if s0 < s1 else 0.7
    else:
        sustain = 0.7
    sustain = float(np.clip(sustain, 0.05, 1.0))

    after = rms_n[peak:]
    below = np.where(after <= sustain * 1.05)[0]
    decay_frames = int(below[0]) if len(below) else max(1, int((total - peak) * 0.15))
    decay_ms = max(decay_frames, 1) * hop / sr * 1000.0

    above = np.where(rms_n > 0.05)[0]
    release_frames = (total - 1 - int(above[-1])) if len(above) else 0
    if release_frames <= 0:
        release_frames = max(1, int(total * 0.1))
    release_ms = release_frames * hop / sr * 1000.0

    return {
        "attack_ms": round(float(np.clip(attack_ms, 1.0, 500.0)), 1),
        "decay_ms": round(float(np.clip(decay_ms, 1.0, 1000.0)), 1),
        "sustain_level": round(sustain, 3),
        "release_ms": round(float(np.clip(release_ms, 5.0, 2000.0)), 1),
    }
