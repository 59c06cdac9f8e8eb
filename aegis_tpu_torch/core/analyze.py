"""The fused analyze step (PyTorch): the port's hot path.

Counterpart of ``aegis_tpu/core/analyze.py``:

    y ──► frames ──► |STFT|² (matmul-DFT) ──► mel ──► dB ──► rake mask
      └─► pYIN frames ──► CMNDF ──► trough probs ──► observations ─► Viterbi
      └─► RMS
      └─► onset envelope (from the same mel)

plus, for the financial engine, the guitar filters and the financial
trend / articulation / slide / confidence stack (``financial_tail``).

On the card the packed program of one key (``fused_graph_key``: the length
bucket, the configuration, the transport, the rows and the device) is
captured once as a CUDA graph (``_FusedGraph``, through ``core/graphs.py``)
at its first dispatch, which its eager warm-up answers, and every later
dispatch with that key replays it: one graph launch in place of ~3 600
kernel launches.  The CPU runs the same program eagerly.

The upload format ("transport") is decided here alone: ``ingest`` takes
every track or live v1 tile that names one.  Left apart, by layout:

  * tiled batches (``quantize_tracks``): one int16 scale a track of a batch;
  * streamed v1 slabs (``engine/turbo.py::stage_int8``): int8 slabs and
    int16 edges at the track's peak, quantized on the device from float32
    uploads (``quantize_pcm8_t``, ``quantize_pcm16_t``, bitwise the host
    quantizers); int16 ones (``quantize_tracks``) where the slab is no
    block multiple or the caller names int16;
  * streamed neural slabs: int16 slabs and edges on one track-wide scale;
  * ``StreamingPolyTranscriber._run_tile``: two slabs on one int16 grid;
  * ``core/hpss.py``: one int16 scale, slabs dequantized before its program;
  * ``models/data.py``: a training bank, with its own rule for near-silence.

The host helpers (bucketing, transports, packing) are copies of the JAX
module's, which the port cannot import because that module imports jax.
Input lengths are padded to the same buckets as the JAX package: the
global max of ``power_to_db`` and the frames near the true end see the
zero-padded bucket tail, so skipping the padding would change edge frames.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import dsp, graphs, masks, trend
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


# The device twins of quantize_pcm8 / quantize_pcm16, bitwise theirs.  Every
# division is a true division of two tensors: PyTorch computes ``127.0 / t``
# as a reciprocal times 127, and on a card ``t / 127.0`` as ``t`` times a
# reciprocal, each an ulp off NumPy's quotient now and then.

def quantize_pcm8_t(y: torch.Tensor):
    """``quantize_pcm8`` of a float32 tensor (a multiple of PCM8_BLOCK
    samples) on its device: (int8 samples, per-block float32 scales,
    per-block peaks)."""
    b = y.reshape(-1, PCM8_BLOCK)
    peak = b.abs().amax(dim=1)
    k = torch.full_like(peak, 127.0)
    q = torch.round(b * (k / peak.clamp_min(1e-30))[:, None])
    return q.to(torch.int8).reshape(-1), peak / k, peak


def quantize_pcm16_t(y: torch.Tensor, peak: torch.Tensor):
    """``quantize_pcm16`` at the samples ``y`` (float32) of a track whose
    abs-max is ``peak`` (a 0-d float32 tensor on their device): (int16
    samples, (1,) float32 scale).  The factor is the float64 quotient
    rounded to float32, as NumPy rounds a Python float before a float32
    product; a silent track gives zeros and scale 0."""
    p = peak.to(torch.float64)
    k = torch.full_like(p, 32767.0)
    factor = torch.where(p > 0, k / p, 0.0).to(torch.float32)
    return (torch.round(y * factor).to(torch.int16),
            (p / k).to(torch.float32).reshape(1))


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


def quantize_tracks(ys: np.ndarray, n_samples: int) -> tuple:
    """(B, *) float tracks -> zero-padded (B, n_samples) int16 + (B,) scales.

    The scale is PER TRACK: with one batch-global peak a track 40 dB quieter
    than the loudest would be quantized with only ~56 dB SNR; per-track
    scaling gives every track the full int16 range regardless of batch
    company."""
    out = np.zeros((len(ys), n_samples), np.int16)
    scales = np.ones(len(ys), np.float32)
    for i, y in enumerate(ys):
        n = min(len(y), n_samples)
        peak = float(np.max(np.abs(np.asarray(y[:n])))) if n else 0.0
        if peak > 0:
            scales[i] = peak / 32767.0
            out[i, :n] = np.round(np.asarray(y[:n], np.float64)
                                  / scales[i]).astype(np.int16)
    return out, scales


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


def stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as the source of an upload to ``device``: in pinned
    memory for a card (a pageable copy would wait for the work already
    queued), else the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> ``device`` without blocking the host: ``stage``, then
    an async copy on the current stream."""
    return stage(a, device).to(device, non_blocking=True)


# each transport's quantizer and the block its samples' length must fill
_QUANTIZERS = {"int8": (quantize_pcm8, PCM8_BLOCK),
               "int4": (quantize_pcm4, PCM4_BLOCK),
               "int16": (quantize_pcm16, 1),
               "float32": (lambda y: (y, 1.0), 1)}
#: a caller that takes fewer passes its subset to ``check_transport``
TRANSPORTS = tuple(_QUANTIZERS)


def check_transport(transport: str, accepted=TRANSPORTS) -> None:
    """Raise the one error for a transport name outside ``accepted``."""
    if transport not in accepted:
        raise ValueError(f"unknown transport {transport!r} "
                         f"({' | '.join(accepted)})")


def put(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A staged tensor (``Ingest``) into the device tensor ``dst`` with no
    host sync: copied from pinned memory, or a 0-d scale filled by value."""
    return (dst.copy_(src, non_blocking=True) if src.dim()
            else dst.fill_(float(src)))


class Ingest(NamedTuple):
    """A track or tile staged on the host (pinned for a card): samples in
    the transport's dtype, a float32 scale of rank 1 (int8, int4: one a
    block) or 0-d (int16, float32), as ``dequant_transport`` reads them."""

    samples: torch.Tensor
    scale: torch.Tensor

    def upload(self, device: torch.device) -> "Ingest":
        """Both on ``device`` (``put``); on the CPU the staged tensors."""
        if device.type != "cuda":
            return self
        return Ingest(*(put(torch.empty_like(t, device=device), t)
                        for t in self))


def ingest(y: np.ndarray, transport: str, device: torch.device,
           accepted=TRANSPORTS) -> Ingest:
    """The one ingest: ``y`` quantized by ``transport`` (one of
    ``accepted``) and staged for ``device``, zero-padded first to a multiple
    of a block transport's block (a bucket-padded track is one already)."""
    check_transport(transport, accepted)
    quantize, block = _QUANTIZERS[transport]
    y = np.asarray(y, np.float32)
    samples, scale = quantize(np.pad(y, (0, -len(y) % block))
                              if len(y) % block else y)
    return Ingest(stage(samples, device),
                  stage(scale, device) if np.ndim(scale)
                  else torch.tensor(scale, dtype=torch.float32))


def packed_program(audio: AudioConfig, pyin_cfg: PyinConfig, tables: Tables,
                   financial: bool, use_guitar_filters: bool,
                   fetch_mel: bool) -> Callable:
    """The packed fused program of one configuration: (samples, scale,
    rake sensitivity) -> packed rows.  The rake is a float, or a 0-d
    float32 tensor (a graph's input), compared in float32 either way."""
    if financial:
        return lambda y, scale, rake: analyze_financial_program_packed(
            y, scale, rake, audio, pyin_cfg, tables, use_guitar_filters,
            fetch_mel)
    return lambda y, scale, rake: analyze_program_packed(
        y, scale, rake, audio, pyin_cfg, tables, fetch_mel)


# ---------------------------------------------------------------------------
# The fused program as CUDA graphs
# ---------------------------------------------------------------------------

#: captured fused programs a card keeps, the least recently used evicted
#: first: the fused path takes tracks up to 240 s by default, which at
#: 44 100 Hz fall in 218 length buckets (129 of them from 15 s up), so
#: every bucket of one configuration stays captured once seen; an evicted
#: key is captured anew at its next dispatch
FUSED_GRAPHS = 256


def fused_graph_key(bucket: int, audio: AudioConfig, pyin_cfg: PyinConfig,
                    transport: str, fetch_mel: bool, financial: bool,
                    use_guitar_filters: bool, device: torch.device) -> tuple:
    """What fixes the fused program's launch sequence and shapes, one
    captured graph each: the padded length, the configurations (n = 450
    and n = 900 decode in different kernels), the transport's dtype and
    scale layout, the packed rows and the device."""
    return (bucket, audio, pyin_cfg, transport, bool(fetch_mel),
            bool(financial), bool(use_guitar_filters), device)


def shared_replays(device: torch.device) -> graphs.Replays:
    """The replays of one card's fused graphs, which share a memory pool.

    Sharing is safe only because no two replays overlap: a graph's
    intermediates (and so its packed output) may sit where another graph's
    intermediates sit, so each replay runs in the card's one turn
    (``Replays.turn``: under its lock, on the stream order after the
    previous replay's copy-out), and its output is cloned before the turn
    ends."""
    return graphs.Replays(device, shared_pool=True)


class _FusedGraph:
    """The packed fused program of one key captured once as a CUDA graph.

    Its static inputs, made before the capture and filled with the inputs
    of the dispatch that captures it, are the transported samples and their
    scale (the ``Ingest`` uploaded) and the rake sensitivity as a 0-d
    float32 tensor, so that one graph serves every rake; ``program`` holds
    the tables the graph reads, which ``tables_from_numpy``'s cache may
    evict.  The capture's eager warm-up answers that dispatch (``first``);
    every later one replays."""

    def __init__(self, replays: graphs.Replays, program: Callable,
                 staged: Ingest, rake: float, bucket: int):
        self.replays, self.program, self.bucket = replays, program, bucket
        device = replays.device
        self.samples, self.scale = staged.upload(device)
        self.rake = torch.full((), rake, dtype=torch.float32, device=device)
        self.captured = graphs.CapturedProgram(
            lambda: program(self.samples, self.scale, self.rake), replays)

    def first(self) -> Optional[torch.Tensor]:
        """The packed rows of the dispatch that captured the graph, from
        its eager warm-up; None once taken."""
        return self.captured.take_first()

    def __call__(self, staged: Ingest, rake: float) -> torch.Tensor:
        """One dispatch, queued on the current stream with no host sync:
        the staged samples and scale (``put``) and the rake in, a clone of
        the packed rows out."""
        with self.replays.turn():
            put(self.samples, staged.samples)
            put(self.scale, staged.scale)
            self.rake.fill_(rake)
            self.replay()
            return self.captured.out.clone()

    def replay(self) -> None:
        """The graph's launch in its ``aegis.fused_graph`` span."""
        with phase("aegis.fused_graph", bucket=self.bucket):
            self.captured.replay()


class FusedGraphs:
    """The captured fused programs of one card by key (``fused_graph_key``):
    at most ``FUSED_GRAPHS``, the least recently used evicted first.  The
    graphs share one memory pool (``shared_replays``); a card with no
    graph left takes a fresh pool, since PyTorch shares no pool that no
    live graph holds.  A capture that fails raises: nothing falls back to
    the eager program.  ``new_replays`` makes a card's replays (a stand-in
    in the CPU tests)."""

    def __init__(self, device: torch.device,
                 new_replays: Callable = shared_replays):
        self.device = device
        self._new_replays = new_replays
        self._replays = None
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def get(self, key, capture: Callable):
        """The graph of ``key`` and whether this call captured it; on a
        miss ``capture(replays)`` makes it, one capture at a time in the
        process (``graphs.CAPTURE_LOCK``), while other keys' graphs
        replay, in an ``aegis.capture`` span (``program``, the graph's
        ``bucket``, and ``evicted``: the graphs the bound dropped for
        it)."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
                return graph, False
        with graphs.CAPTURE_LOCK:
            with self._lock:
                graph = self._graphs.get(key)
                if graph is not None:
                    return graph, False
                if not self._graphs:
                    self._replays = self._new_replays(self.device)
                replays = self._replays
            with phase("aegis.capture", program="fused") as span:
                graph = capture(replays)
                evicted = 0
                with self._lock:
                    self._graphs[key] = graph
                    while len(self._graphs) > FUSED_GRAPHS:
                        self._graphs.popitem(last=False)
                        evicted += 1
                if span is not None:
                    span.attrs.update(bucket=graph.bucket, evicted=evicted)
        return graph, True


_CARDS: Dict[torch.device, FusedGraphs] = {}
_CARDS_LOCK = threading.Lock()


def fused_graphs(device: torch.device) -> FusedGraphs:
    """The fused graphs of one card (a ``torch.device`` with its index)."""
    with _CARDS_LOCK:
        if device not in _CARDS:
            _CARDS[device] = FusedGraphs(device)
        return _CARDS[device]


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
    which uploads them once; on the card it also captures the program of
    its key (``fused_graph_key``) as a CUDA graph, which every later call
    with that key replays."""
    with phase("aegis.enqueue"):
        device = resolve_device(device)
        true_frames = audio.n_frames(len(y))
        y_pad = pad_to_bucket(np.asarray(y, np.float32))
        staged = ingest(y_pad, transport, device)
        rows = _FIN_ROWS if financial else _V1_ROWS

        def program():
            return packed_program(
                audio, pyin_cfg, tables_from_numpy(audio, pyin_cfg, device),
                financial, use_guitar_filters, fetch_mel)

        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            key = fused_graph_key(len(y_pad), audio, pyin_cfg, transport,
                                  fetch_mel, financial, use_guitar_filters,
                                  device)
            graph, captured = fused_graphs(device).get(
                key, lambda replays: _FusedGraph(
                    replays, program(), staged, rake_sensitivity,
                    len(y_pad)))
            packed = (graph.first() if captured
                      else graph(staged, rake_sensitivity))
        else:
            packed = program()(*staged.upload(device), rake_sensitivity)
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
