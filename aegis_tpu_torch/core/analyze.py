"""The fused analyze step (PyTorch): the port's hot path.

Counterpart of ``aegis_tpu/core/analyze.py``:

    y ──► frames ──► |STFT|² (matmul-DFT) ──► mel ──► dB ──► rake mask
      └─► pYIN frames ──► CMNDF ──► trough probs ──► observations ─► Viterbi
      └─► RMS
      └─► onset envelope (from the same mel)

plus, for the financial engine, the guitar filters and the financial
trend / articulation / slide / confidence stack (``financial_tail``).

The host helpers (bucketing, transports, packing) are copies of the JAX
module's, which the port cannot import because that module imports jax.
Input lengths are padded to the same buckets as the JAX package: the
global max of ``power_to_db`` and the frames near the true end see the
zero-padded bucket tail, so skipping the padding would change edge frames.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import dsp, masks, trend
from aegis_tpu_torch.core.cqt import onset_strength_t
from aegis_tpu_torch.core.pyin import extract_pyin_frames, pyin_from_frames
from aegis_tpu_torch.core.tables import Tables, tables_from_numpy
from aegis_tpu_torch.utils.prof import phase

MIN_BUCKET = 1 << 16  # ~3 s @ 22050

# Block size for the int8 block-float transport (one scale per block).
# Must divide every bucket length (bucket_length returns multiples of 4096).
PCM8_BLOCK = 1024


def bucket_length(n: int) -> int:
    """Smallest padded length >= n on a 32-steps-per-octave grid (the JAX
    package's buckets: <= ~3.2% padding above 2^17 samples, a 2^12 grid
    floor, and MIN_BUCKET below)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    g = 1 << max((n - 1).bit_length() - 6, 12)
    return -(-n // g) * g


def pad_to_bucket(y: np.ndarray) -> np.ndarray:
    b = bucket_length(len(y))
    if b == len(y):
        return y
    return np.pad(y, (0, b - len(y)))


def reflect_head(x: np.ndarray, ctx: int, half_window: int,
                 true_len: Optional[int] = None) -> np.ndarray:
    """Track-head left context for a FIRST tile: the offline frame_signal
    'reflect' pad convention (x[1..m] reversed, m bounded by the window
    half and the true track length) placed at the tail of a ``ctx``-wide
    zero pad.  ONE definition shared by the offline poly turbo path and
    the live streaming transcribers — the streamed==offline parity tests
    depend on the two conventions staying byte-identical.  Works on 1-D
    samples or a (B, n) batch (last axis = time)."""
    L = x.shape[-1] if true_len is None else true_len
    m = min(half_window, max(L - 1, 0))
    out = np.zeros(x.shape[:-1] + (ctx,), x.dtype)
    if m:
        out[..., ctx - m:] = x[..., m:0:-1]
    return out


def quantize_pcm16(y: np.ndarray):
    """ONE track -> (int16 PCM, dequant scale float), peak-scaled.  A silent
    track returns scale 0.0."""
    y = np.asarray(y)
    peak = float(np.max(np.abs(y))) if y.size else 0.0
    if peak <= 0:
        return np.zeros(y.shape, np.int16), 0.0
    return np.round(y * (32767.0 / peak)).astype(np.int16), peak / 32767.0


def quantize_pcm8(y: np.ndarray):
    """ONE bucket-padded track -> (int8 PCM, per-block float32 scales):
    block-floating-point transport, one peak scale per PCM8_BLOCK samples.
    Silent blocks return scale 0.0."""
    y = np.asarray(y, np.float32)
    if len(y) % PCM8_BLOCK:
        raise ValueError(f"int8 transport needs len % {PCM8_BLOCK} == 0 "
                         f"(bucket-pad first), got {len(y)}")
    b = y.reshape(-1, PCM8_BLOCK)
    peak = np.abs(b).max(axis=1)
    q = np.round(b * (127.0 / np.maximum(peak[:, None], 1e-30)))
    return q.astype(np.int8).reshape(-1), (peak / 127.0).astype(np.float32)


# Block size for the int4 packed block-float transport (one scale per block;
# even, since two samples pack a byte, and a divisor of every bucket length).
PCM4_BLOCK = 128


def quantize_pcm4(y: np.ndarray, block: int = PCM4_BLOCK):
    """ONE bucket-padded track -> (packed uint8 nibble pairs of length
    len(y)//2, per-block float32 scales): int4 block-floating-point
    transport at a quarter of the int16 bytes.  Sample 2i rides the LOW
    nibble of byte i, sample 2i+1 the HIGH nibble, two's-complement in
    [-7, 7].  Opt-in: the ~19 dB noise floor under each block's peak is
    transparent on the gating clips but lossy off them (the JAX package's
    VALIDATION.md §A)."""
    y = np.asarray(y, np.float32)
    if len(y) % block or block % 2:
        raise ValueError(f"int4 transport needs even block | len "
                         f"({block}, {len(y)})")
    b = y.reshape(-1, block)
    peak = np.abs(b).max(axis=1)
    q = np.round(b * (7.0 / np.maximum(peak[:, None], 1e-30)))
    qi = q.astype(np.int8).reshape(-1)
    packed = ((qi[0::2] & 0xF) | ((qi[1::2] & 0xF) << 4)).astype(np.uint8)
    return packed, (peak / 7.0).astype(np.float32)


def dequant_transport(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A 0-d ``scale`` is the int16 (or float32 pass-through) convention; a
    rank-1 ``scale`` is block-float: int8, one scale per PCM8_BLOCK, or
    int4 nibble pairs (quantize_pcm4) when ``y`` arrives as uint8."""
    if y.dtype == torch.uint8:  # packed int4 nibble pairs
        b = y.to(torch.int32)
        lo = b & 0xF
        hi = (b >> 4) & 0xF
        lo = lo - torch.where(lo >= 8, 16, 0)
        hi = hi - torch.where(hi >= 8, 16, 0)
        yf = torch.stack([lo, hi], dim=-1).reshape(-1).to(torch.float32)
        return (yf.reshape(scale.shape[0], -1) * scale[:, None]).reshape(-1)
    y = y.to(torch.float32)
    if scale.dim() == 1:
        return (y.reshape(scale.shape[0], -1) * scale[:, None]).reshape(-1)
    return y * scale


def analyze_program(y: torch.Tensor, rake_sensitivity: float,
                    audio: AudioConfig, pyin_cfg: PyinConfig,
                    tables: Tables) -> Dict[str, torch.Tensor]:
    """v1 Perception Phase.  Returns time-major tensors; f0 is NaN on
    unvoiced frames."""
    y = y.to(torch.float32)
    mel = dsp.melspectrogram_t(y, audio.hop_length, tables)
    mel_db = dsp.power_to_db(mel)
    rake = masks.detect_rake(mel_db, audio.hop_length, audio.sample_rate,
                             rake_sensitivity)

    frames = extract_pyin_frames(y, audio.hop_length, pyin_cfg)
    f0, voiced, probs = (a[0] for a in pyin_from_frames(
        frames[None], audio.sample_rate, pyin_cfg, tables))
    rms_ = dsp.rms(y, pyin_cfg.frame_length, audio.hop_length)
    return {
        "mel_db": mel_db,
        "rake_mask": rake,
        "f0": f0,
        "voiced_flag": voiced,
        "voiced_probs": probs,
        "rms": rms_,
        "onset_env": onset_strength_t(mel),  # same mel, ~free
    }


def financial_tail(base: Dict[str, torch.Tensor], audio: AudioConfig,
                   use_guitar_filters: bool = True) -> Dict[str, torch.Tensor]:
    """Phases 3.5-4a on top of a base analysis dict with {f0, voiced_flag,
    voiced_probs, rake_mask, mel_db}: the guitar-specific filters plus the
    financial trend / articulation / slide / confidence stack."""
    f0, voiced, rake = base["f0"], base["voiced_flag"], base["rake_mask"]
    mel_db = base["mel_db"]

    if use_guitar_filters:
        f0, voiced = masks.filter_subharmonic(f0, voiced, fmin_hz=82.4)
        rake = masks.enhance_rake(mel_db, audio.hop_length, audio.sample_rate,
                                  rake)
        mute = masks.detect_palm_mute(mel_db, audio.hop_length,
                                      audio.sample_rate)
        voiced = voiced & ~mute
        dist = masks.distortion_score(mel_db)
    else:
        mute = torch.zeros_like(rake)
        dist = torch.zeros((), dtype=torch.float32, device=f0.device)

    f0_clean = torch.where(voiced, f0, float("nan"))
    with phase("aegis.trend"):
        fin = trend.analyze_pitch_financial(f0_clean)
        combined_conf = base["voiced_probs"] * 0.5 + fin["confidence"] * 0.5
        adaptive_thr = trend.adaptive_confidence_threshold(combined_conf)
    return {
        **base,
        "f0": f0,
        "voiced_flag": voiced,
        "rake_mask": rake,
        "mute_mask": mute,
        "distortion_score": dist,
        "trend": fin["trend"],
        "artic_codes": fin["articulations"],
        "slide_codes": fin["slides"],
        "financial_confidence": fin["confidence"],
        "combined_confidence": combined_conf,
        "adaptive_threshold": adaptive_thr,
    }


def analyze_financial_program(y: torch.Tensor, rake_sensitivity: float,
                              audio: AudioConfig, pyin_cfg: PyinConfig,
                              tables: Tables, use_guitar_filters: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """v2 pipeline phases 1-4a: mel / rake / pYIN / RMS plus the guitar
    filters and the financial trend, articulation, slide and confidence
    analysis."""
    base = analyze_program(y, rake_sensitivity, audio, pyin_cfg, tables)
    return financial_tail(base, audio, use_guitar_filters)


# Per-frame output rows packed beside mel_db into ONE buffer, so the
# device->host fetch is a single copy.  Per-track scalars ride along
# broadcast to (T,).
_V1_ROWS = ("f0", "voiced_flag", "voiced_probs", "rms", "rake_mask",
            "onset_env")
_FIN_ROWS = _V1_ROWS + (
    "mute_mask", "trend", "artic_codes", "slide_codes",
    "financial_confidence", "combined_confidence",
    "adaptive_threshold", "distortion_score",
)
# streamed-slab rows: the financial per-tile (local) outputs without the
# whole-track trend stack, which run_analyze_streamed computes afterwards in
# one small full-track pass (engine.turbo)
_GTR_ROWS = _V1_ROWS + ("mute_mask", "dist_high_sum", "dist_total_sum")
_BOOL_ROWS = {"voiced_flag", "rake_mask", "mute_mask"}
_INT_ROWS = {"artic_codes": np.int8, "slide_codes": np.int8}


def _pack(out: Dict[str, torch.Tensor], rows, include_mel: bool) -> torch.Tensor:
    T = out["f0"].shape[0]
    cols = [torch.broadcast_to(out[k].to(torch.float32), (T,))[:, None]
            for k in rows]
    head = [out["mel_db"]] if include_mel else []
    return torch.cat(head + cols, dim=1)


def analyze_program_packed(y: torch.Tensor, scale: torch.Tensor,
                           rake_sensitivity: float, audio: AudioConfig,
                           pyin_cfg: PyinConfig, tables: Tables,
                           include_mel: bool = True) -> torch.Tensor:
    """The v1 program on a transported track (``dequant_transport``), its
    rows packed into one (T, [n_mels +] len(_V1_ROWS)) buffer on the
    track's device."""
    y = dequant_transport(y, scale)
    return _pack(analyze_program(y, rake_sensitivity, audio, pyin_cfg, tables),
                 _V1_ROWS, include_mel)


def analyze_financial_program_packed(y: torch.Tensor, scale: torch.Tensor,
                                     rake_sensitivity: float,
                                     audio: AudioConfig, pyin_cfg: PyinConfig,
                                     tables: Tables,
                                     use_guitar_filters: bool = True,
                                     include_mel: bool = True) -> torch.Tensor:
    """The financial program on a transported track, packed as
    ``analyze_program_packed`` packs the v1 one (rows ``_FIN_ROWS``)."""
    y = dequant_transport(y, scale)
    return _pack(
        analyze_financial_program(y, rake_sensitivity, audio, pyin_cfg,
                                  tables, use_guitar_filters),
        _FIN_ROWS, include_mel,
    )


def _unpack(buf: np.ndarray, rows, n_mels: int) -> Dict[str, np.ndarray]:
    """Packed buffer (..., n_mels + len(rows)) -> named arrays, for the
    single-track (T, C) layout and the batch (B, T, C) layout alike."""
    result: Dict[str, np.ndarray] = (
        {"mel_db": buf[..., :n_mels]} if n_mels else {})
    for i, k in enumerate(rows):
        col = buf[..., n_mels + i]
        if k in _BOOL_ROWS:
            result[k] = col > 0.5
        elif k in _INT_ROWS:
            result[k] = col.astype(_INT_ROWS[k])
        elif k in ("adaptive_threshold", "distortion_score"):
            # per-track scalar: (B,) in the batch layout, float in the
            # single-track layout
            result[k] = (col[:, 0].astype(np.float32) if col.ndim == 2
                         else np.float32(col.reshape(-1)[0]))
        else:
            result[k] = col.astype(np.float64) if k == "f0" else col
    return result


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> ``device`` without blocking the host: a CUDA upload
    goes through pinned memory as an async copy on the current stream (a
    pageable copy would wait for the work already queued)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def dispatch_analyze(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    financial: bool = False,
    use_guitar_filters: bool = True,
    fetch_mel: bool = True,
    transport: str = "int8",
    device="cuda",
):
    """Async half of run_analyze: bucket-pad, quantize, upload, queue the
    analyze step on ``device`` and return an opaque handle WITHOUT waiting
    for the device (no ``.item()``, no ``.cpu()``), so several tracks can be
    in flight before any fetch.  Resolve with fetch_analyze(handle).  The
    first call for a new length or config builds its constant tables,
    which uploads them once."""
    with phase("aegis.enqueue"):
        device = resolve_device(device)
        true_frames = audio.n_frames(len(y))
        y_pad = pad_to_bucket(np.asarray(y, np.float32))
        if transport == "int8":
            y8, s8 = quantize_pcm8(y_pad)
            y_dev, scale = upload(y8, device), upload(s8, device)
        elif transport == "int4":
            y4, s4 = quantize_pcm4(y_pad)
            y_dev, scale = upload(y4, device), upload(s4, device)
        elif transport == "int16":
            y16, s = quantize_pcm16(y_pad)
            y_dev = upload(y16, device)
            scale = torch.full((), s, dtype=torch.float32, device=device)
        elif transport == "float32":
            y_dev = upload(y_pad, device)
            scale = torch.ones((), dtype=torch.float32, device=device)
        else:
            raise ValueError(f"unknown transport {transport!r} "
                             "(int8 | int4 | int16 | float32)")
        tables = tables_from_numpy(audio, pyin_cfg, device)
        if financial:
            packed = analyze_financial_program_packed(
                y_dev, scale, rake_sensitivity, audio, pyin_cfg, tables,
                use_guitar_filters, fetch_mel)
            rows = _FIN_ROWS
        else:
            packed = analyze_program_packed(y_dev, scale, rake_sensitivity,
                                            audio, pyin_cfg, tables,
                                            fetch_mel)
            rows = _V1_ROWS
        return packed, rows, true_frames, audio.n_mels if fetch_mel else 0


def fetch_analyze(handle) -> Dict[str, np.ndarray]:
    """Blocking half: copy the packed buffer to the host and unpack it."""
    packed, rows, true_frames, n_mels = handle
    with phase("aegis.fetch"):
        return _unpack(packed[:true_frames].cpu().numpy(), rows, n_mels)


def run_analyze(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    financial: bool = False,
    use_guitar_filters: bool = True,
    fetch_mel: bool = True,
    transport: str = "int8",
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Host wrapper: bucket-pad, quantize for the upload, run the analyze
    step on ``device``, fetch the single packed buffer, truncate to the
    true frame count, return NumPy arrays.

    financial=True adds the guitar filters and the financial rows
    (_FIN_ROWS).  transport: "int8" (default, block-floating-point 8-bit
    PCM), "int4" (packed block-float nibbles, opt-in: see quantize_pcm4),
    "int16" (peak-scaled) or "float32" (bit-exact ingest)."""
    return fetch_analyze(dispatch_analyze(
        y, audio, pyin_cfg, rake_sensitivity, financial, use_guitar_filters,
        fetch_mel, transport, device))
