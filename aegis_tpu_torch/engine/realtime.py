"""Realtime (online) transcription: feed PCM chunks, poll events live.

Counterpart of ``aegis_tpu/engine/realtime.py``: stateful transcribers (v1,
financial, polyphonic) for LIVE input — an audio interface, a network
stream, a DAW bridge.  It reuses the tile machinery of ``engine/turbo.py``
(``_tile_mel_power`` and ``_tile_analyze``: the haloed pYIN / mel / rake
program at M = 1 slab, so every tile is one launch of each Viterbi kernel at
B = 1 and T = tile + 2 * halo frames) with two online adaptations:

  * CAUSAL dB reference: the offline pipelines reference power_to_db to the
    track-global mel peak (ref=max); a live stream can't see the future, so
    the reference is the RUNNING max, carried from tile to tile as a 0-d
    tensor on the device (never fetched: the rows block is the one
    device→host copy a tile).  Once the loudest attack so far has passed,
    tiles match the offline tiled rows exactly (tested: a loud-first clip
    reproduces run_analyze_turbo's events at F1 = 1.0).
  * Bounded lookahead: a tile is analyzed only once its right halo has
    arrived, so the intrinsic latency is (tile + halo·hop + fl/2) samples
    (``lookahead_s``).  The DEFAULT config is the low-latency preset
    (24, 8); pass tile_frames=64, halo_frames=32 for a higher-throughput
    stream.  Bulk re-analysis of FILES should use the offline engines
    (fused / tiles / stream).  The card's own tile times, ingest margins
    and poll times are in PERF.md.

On the card the tile program's launch sequence is captured once as a CUDA
graph for each (config, device), and every tile of every session of that
program replays it (``_LiveGraph``); the CPU runs the same body eagerly.
A session keeps its first tile's program: an eviction from
``_tile_program``'s cache costs a later session one capture, not a tile.

Host memory grows only by the per-frame output rows (~40 B/frame);
``poll_events()`` re-runs the (native C++) event extraction over the
accumulated rows — the same "instant re-filter" contract as the offline
Phase 2.  As in the JAX package the whole-track trend stack of a financial
stream runs on the HOST at poll time (``core/trend_fast.py``, bit-identical
to the NumPy oracle), not through the device scans of ``core/trend.py``.

``StreamingPolyTranscriber`` is the chord-capable sibling on the raw-voice
poly transport (``engine.turbo.poly_tile_rows`` at M = 1): a tile is one
upload of its two slabs and one device->host copy of its rows, and the
voice-acceptance peak is applied on the host at poll time.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.core import graphs
from aegis_tpu_torch.core.analyze import (_BOOL_ROWS, _GTR_ROWS, _V1_ROWS,
                                          ingest, put, quantize_pcm16,
                                          reflect_head, upload)
from aegis_tpu_torch.core.poly import unpack_poly_voices
from aegis_tpu_torch.utils.prof import phase

# ---------------------------------------------------------------------------
# Finalized-event horizon: a live poll that re-runs extraction +
# the whole refinement chain over EVERY accumulated frame costs time
# linear in the session length.  Events far enough behind the newest frame can never change:
# new audio only appends frames, every extraction pass reads bounded local
# windows, and the global scalars it consumes (track peaks, picked onsets,
# the adaptive threshold, the detected key) are either fingerprinted or
# re-applied per poll.  poll_events() therefore caches events behind a
# FREEZE CUT and re-extracts only the active tail; equality with the full
# re-extraction is pinned by tests/test_torch_realtime.py.
# ---------------------------------------------------------------------------

#: freeze distance from the newest frame — events ending after T - _HZN_K
#: may still merge/extend/split as audio arrives
_HZN_K = 128
#: re-extraction left margin ahead of the cut (covers medfilt, snap-back,
#: attack/birth windows, sustain merges and the recovery passes' skips)
_HZN_PRE = 128
#: required quiet + onset-free margin before a valid cut (> the largest
#: merge gap / snap window / birth tolerance in any extractor)
_HZN_QUIET = 16


def _find_cut(onsets: np.ndarray, lo: int, hi: int, quiet: int,
              cross_fn, event_starts=None) -> Optional[int]:
    """Largest valid freeze cut b in (lo, hi]: requires

      * no picked onsets in [b-quiet, b) — snap targets stay >= b, so no
        tail event's snapped start can reach the frozen side;
      * ``cross_fn(b)`` False — the engine-specific proof that no
        segmentation run / sustain merge can span b (a silence window for
        the poly roll, a same-note activation-pair check for the
        monophonic extractors);
      * with ``event_starts`` given (the poly chain's decay_prune), a
        CLOSED decay gap: the last onset before b must not precede any
        event start < b — an event past the final onset reads its
        inter-onset gap up to the growing stream end (the total_frames
        fallback), so its judgment is not final.

    Conservative by construction: rejecting a valid cut only costs tail
    length, never exactness."""
    if hi <= lo or len(onsets) == 0:
        return None
    on = np.asarray(onsets, np.int64)
    ev_starts = (np.asarray(sorted(event_starts), np.int64)
                 if event_starts is not None else None)
    for b in range(hi, lo, -8):
        w0 = max(b - quiet, 0)
        if ((on >= w0) & (on < b)).any():
            continue
        if cross_fn(b):
            continue
        if ev_starts is not None:
            prev_on = on[on < b]
            if len(prev_on) == 0:
                continue
            o_b = int(prev_on[-1])
            # events starting at or after the last pre-cut onset have an
            # unclosed inter-onset gap
            k0 = int(np.searchsorted(ev_starts, o_b, "left"))
            k1 = int(np.searchsorted(ev_starts, b))
            if k1 > k0:
                continue
        return b
    return None


def _span_cross_fn(events: List[dict], chain_gap: Optional[int] = None):
    """Event-level crossing test: b is crossed iff some (post-snap) event
    has start < b <= end.  With events sorted by start, that is
    ``max(end over starts < b) >= b`` — one searchsorted against a prefix
    max of ends.  Valid cuts therefore sit exactly at snapped event
    starts (onsets), which exist even in continuously-voiced material
    where no activation-quiet window ever does.

    ``chain_gap`` (the monophonic extractors) additionally fuses
    same-note events within that many frames of each other into ONE span
    before the test: an onset-split piece INHERITS its pre-split merged
    parent's attributes (confidence is read once at the chain head), so
    a contiguous same-note chain carries provenance across any cut
    inside it even though no single event spans it — a chain-merged
    palm-mute chug re-split at every onset is the measured shape."""
    if chain_gap is not None and events:
        spans: List[list] = []
        for e in sorted(events, key=lambda e: (e["note"], e["start"])):
            if (spans and spans[-1][2] == e["note"]
                    and e["start"] - spans[-1][1] <= chain_gap + 1):
                spans[-1][1] = max(spans[-1][1], e["end"])
            else:
                spans.append([e["start"], e["end"], e["note"]])
        starts = np.asarray([s[0] for s in spans], np.int64)
        ends = np.asarray([s[1] for s in spans], np.int64)
    else:
        starts = np.fromiter((e["start"] for e in events), np.int64,
                             len(events))
        ends = np.fromiter((e["end"] for e in events), np.int64,
                           len(events))
    order = np.argsort(starts, kind="stable")
    s_sorted = starts[order]
    pmax_end = (np.maximum.accumulate(ends[order])
                if len(s_sorted) else ends)

    def cross(b):
        k = int(np.searchsorted(s_sorted, b, "left"))
        return k > 0 and int(pmax_end[k - 1]) >= b

    return cross


def _shift_events(events: List[dict], off: int) -> List[dict]:
    for e in events:
        e["start"] += off
        e["end"] += off
    return events


class _RowCat:
    """Append-only concatenation cache for the per-tile row blocks.

    Blocks are immutable and only ever appended, so instead of a fresh
    ``np.concatenate(self._rows)`` over the whole session at every poll
    this keeps one growing buffer (capacity doubles, amortized O(1) per
    appended frame) and copies only the new blocks in — the returned view
    holds bit-identical values to the fresh concatenate (it is the same
    copy, made once), pinned by tests/test_torch_realtime_copies.py.

    The cache validates itself: it remembers the last block it copied and
    starts over when the list is shorter than what it has seen or when the
    block at that position is another object (a list truncated and regrown
    to the same length between two calls)."""

    def __init__(self):
        self._buf: Optional[np.ndarray] = None
        self._len = 0
        self._blocks = 0
        self._last: Optional[np.ndarray] = None   # the block cached last

    def view(self, rows: List[np.ndarray]) -> np.ndarray:
        if (self._blocks > len(rows)
                or (self._blocks and rows[self._blocks - 1] is not self._last)):
            self._buf, self._len, self._blocks, self._last = None, 0, 0, None
        for b in rows[self._blocks:]:
            need = self._len + len(b)
            if self._buf is None or need > len(self._buf):
                cap = max(need, 2 * self._len, 4096)
                grown = np.empty((cap,) + b.shape[1:], b.dtype)
                if self._len:
                    grown[:self._len] = self._buf[:self._len]
                self._buf = grown
            self._buf[self._len:need] = b
            self._len = need
        self._blocks = len(rows)
        self._last = rows[-1] if rows else None
        return self._buf[:self._len]


class _LiveGraph:
    """The tile body captured once as a CUDA graph, replayed for every tile.

    The body's launch sequence is fixed for one (config, device): one slab
    length, B = 1, T = tile + 2 * halo.  Its inputs (the int16 slab, the
    0-d dequant scale, the 0-d rake sensitivity, the 0-d running
    reference) and outputs (the packed rows, the new reference) are static
    tensors shared by every session of the program, so a replay takes the
    graph's turn (``graphs.Replays``) from the copies into the inputs to
    the copies out of the outputs.  The graph has a memory pool of its
    own."""

    def __init__(self, body, slab_len: int, device: torch.device):
        self.device = device
        self.slab16 = torch.zeros(slab_len, dtype=torch.int16, device=device)
        self.scale = torch.zeros((), dtype=torch.float32, device=device)
        self.rake = torch.zeros((), dtype=torch.float32, device=device)
        self.ref = torch.zeros((), dtype=torch.float32, device=device)
        self.replays = graphs.Replays(device)
        self.program = graphs.CapturedProgram(
            lambda: body(self.slab16, self.scale, self.rake, self.ref),
            self.replays)
        self.program.first = None          # the first tile replays too
        self.rows, self.new_ref = self.program.out

    def __call__(self, slab16: torch.Tensor, scale: torch.Tensor,
                 rake_sens: float, ref_power: torch.Tensor):
        """One tile: the session's staged slab and scale (``put``), its
        rake sensitivity and its own reference in, its rows (a new tensor)
        out; ``ref_power`` is updated in place."""
        with self.replays.turn():
            put(self.slab16, slab16)
            put(self.scale, scale)
            self.rake.fill_(rake_sens)
            self.ref.copy_(ref_power)
            with phase("aegis.live_graph"):
                self.program.replay()
            ref_power.copy_(self.new_ref)
            rows = self.rows.clone()
        return rows, ref_power


class _TileProgram:
    """One live tile program per (config, device): slab + running dB ref ->
    packed rows + updated ref.  ``financial=True`` adds the per-tile
    guitar-filter rows (_GTR_ROWS: mute mask, sub-E2-corrected f0,
    distortion partial sums) — the whole-track trend stack runs on the
    HOST at poll time.

    On the CPU every tile runs ``body`` eagerly.  On CUDA the body is
    captured once, at the first tile (``_LiveGraph``, in an
    ``aegis.capture`` span), and every tile of every session replays it:
    one graph launch in place of ~3 600 kernel launches.  A capture that
    fails raises; nothing falls back to the eager body."""

    def __init__(self, audio: AudioConfig, pyin_cfg: PyinConfig,
                 turbo: TurboConfig, financial: bool,
                 use_guitar_filters: bool, device: torch.device):
        from aegis_tpu_torch.core.tables import tables_from_numpy

        self.audio, self.pyin_cfg, self.turbo = audio, pyin_cfg, turbo
        self.financial = financial
        self.use_guitar_filters = use_guitar_filters
        self.device = device
        self.rows_spec = _GTR_ROWS if financial else _V1_ROWS
        self.tables = tables_from_numpy(audio, pyin_cfg, device)
        self._graph: Optional[_LiveGraph] = None

    def body(self, slab16: torch.Tensor, scale: torch.Tensor,
             rake_sens: torch.Tensor, ref_power: torch.Tensor):
        """The tile's device work over fixed-shape tensors: the int16 slab
        (span,), its 0-d float32 dequant scale, the 0-d float32 rake
        sensitivity and the 0-d running reference -> rows (tile,
        len(rows_spec)), the new reference."""
        from aegis_tpu_torch.engine.turbo import _tile_analyze, _tile_mel_power

        audio, pyin_cfg, turbo = self.audio, self.pyin_cfg, self.turbo
        tile, halo = turbo.tile_frames, turbo.halo_frames
        amin = 1e-10
        slab = (slab16.to(torch.float32) * scale)[None]          # (1, span)
        mel_power = _tile_mel_power(slab, audio, pyin_cfg, turbo, self.tables)
        # causal running reference over tile INTERIORS (halo frames are
        # interior frames of neighboring tiles)
        interior_max = torch.amax(mel_power[:, halo: halo + tile])
        new_ref = torch.maximum(ref_power, interior_max)
        mel_db = 10.0 * torch.log10(torch.clamp_min(mel_power, amin))
        mel_db = mel_db - 10.0 * torch.log10(torch.clamp_min(new_ref, amin))
        mel_db = torch.clamp_min(mel_db, -80.0)
        out = _tile_analyze(slab, mel_db, rake_sens, audio, pyin_cfg, turbo,
                            self.tables, financial=self.financial,
                            use_guitar_filters=self.use_guitar_filters)
        cols = [out[k][0].to(torch.float32)[:, None] for k in self.rows_spec]
        return torch.cat(cols, dim=1), new_ref

    def __call__(self, slab16: torch.Tensor, scale: torch.Tensor,
                 rake_sens: float, ref_power: torch.Tensor):
        """One tile: the int16 slab and its 0-d scale as ``ingest`` stages
        them, the rake sensitivity and the session's reference -> (rows,
        new reference), both on the device.  The rake enters as a float32,
        the type it is compared in."""
        with phase("aegis.live_tile"):
            if self.device.type != "cuda":
                return self.body(slab16, scale, torch.tensor(
                    rake_sens, dtype=torch.float32), ref_power)
            if self._graph is None:
                with graphs.CAPTURE_LOCK:
                    if self._graph is None:
                        with phase("aegis.capture", program="live",
                                   evicted=0):
                            self._graph = _LiveGraph(
                                self.body, slab16.shape[0], self.device)
            return self._graph(slab16, scale, rake_sens, ref_power)


@functools.lru_cache(maxsize=8)
def _tile_program(audio: AudioConfig, pyin_cfg: PyinConfig,
                  turbo: TurboConfig, financial: bool = False,
                  use_guitar_filters: bool = True,
                  device: torch.device = torch.device("cpu")) -> _TileProgram:
    """The live tile program of one (config, device), built once."""
    return _TileProgram(audio, pyin_cfg, turbo, financial,
                        use_guitar_filters, device)


class StreamingTranscriber:
    """Online chunk-fed transcription (the v1 pipeline, or with
    ``financial=True`` the financial one).  Runs on the card unless the
    caller names ``device="cpu"``; without a card the default raises.

    >>> rt = StreamingTranscriber()
    >>> for chunk in audio_source:        # arbitrary chunk sizes
    ...     rt.feed(chunk)
    ...     events = rt.poll_events()     # live event list so far
    >>> events = rt.finalize()            # flush the tail
    """

    def __init__(self, audio: Optional[AudioConfig] = None,
                 pyin_cfg: Optional[PyinConfig] = None,
                 tile_frames: int = 24, halo_frames: int = 8,
                 rake_sensitivity: float = 0.6,
                 financial: bool = False,
                 use_guitar_filters: bool = True,
                 device="cuda",
                 **extract_kwargs):
        self.device = resolve_device(device)
        self.audio = audio or AudioConfig()
        self.pyin_cfg = pyin_cfg or PyinConfig()
        self.turbo = TurboConfig(tile_frames=tile_frames,
                                 halo_frames=halo_frames)
        self.rake_sensitivity = rake_sensitivity
        self.financial = financial
        self.use_guitar_filters = use_guitar_filters
        self._rows_spec = _GTR_ROWS if financial else _V1_ROWS
        self.extract_kwargs = extract_kwargs

        hop = self.audio.hop_length
        fl = self.pyin_cfg.frame_length
        self._ctx = halo_frames * hop + fl // 2   # samples of halo context
        self._tile_samp = tile_frames * hop
        # pending raw samples; starts with ctx zeros = the offline
        # center/leading-pad convention for the first tile's left halo
        self._pending = np.zeros(self._ctx, np.float32)
        self._rows: List[np.ndarray] = []         # per-tile (tile, 6) rows
        self._fin_trend_cache = None              # incremental poll trend
        self._onset_state = None                  # incremental onset pick
        self._cat = _RowCat()                     # append-only row concat
        self._hzn: Optional[dict] = None          # finalized-event horizon
        # running mel-power dB reference, kept on the device between tiles
        self._ref_power = torch.zeros((), dtype=torch.float32,
                                      device=self.device)
        self._program: Optional[_TileProgram] = None  # from the first tile
        self._n_fed = 0
        self._final_rows: Optional[Dict[str, np.ndarray]] = None  # finalized

    # ------------------------------------------------------------------ props

    @property
    def lookahead_s(self) -> float:
        """Intrinsic latency: a tile is analyzed once its right halo exists."""
        return (self._tile_samp + self._ctx) / float(self.audio.sample_rate)

    @property
    def frames_analyzed(self) -> int:
        return len(self._rows) * self.turbo.tile_frames

    # ------------------------------------------------------------------ feed

    def feed(self, chunk: np.ndarray) -> int:
        """Append PCM samples; analyzes every tile whose halo is complete.
        Returns the number of tiles analyzed by this call."""
        if self._final_rows is not None:
            # finalize() flushed the tail with silence padding; accepting
            # more audio would time-shift every later event by the pad and
            # silently drop the real tail on a re-finalize
            raise RuntimeError("stream already finalized; feed() is no "
                               "longer accepted")
        with phase("live.feed"):
            chunk = np.asarray(chunk, np.float32).reshape(-1)
            self._pending = np.concatenate([self._pending, chunk])
            self._n_fed += len(chunk)
            span = self._ctx + self._tile_samp + self._ctx  # left+tile+right
            done = 0
            while len(self._pending) >= span:
                self._run_tile(self._pending[:span])
                # keep the tail from the tile start onward (next tile's
                # left halo is this tile's tail)
                self._pending = self._pending[self._tile_samp:]
                done += 1
            return done

    def _run_tile(self, slab: np.ndarray) -> None:
        if self._program is None:
            self._program = _tile_program(
                self.audio, self.pyin_cfg, self.turbo, self.financial,
                self.use_guitar_filters, self.device)
        rows, self._ref_power = self._program(
            *ingest(slab, "int16", self.device),
            float(self.rake_sensitivity), self._ref_power)
        # the tile's one device->host copy; the reference stays on the device
        with phase("aegis.live_fetch"):
            self._rows.append(rows.cpu().numpy())

    # ------------------------------------------------------------------ read

    def _stacked(self, n_frames: Optional[int] = None) -> Dict[str, np.ndarray]:
        spec = self._rows_spec
        if not self._rows:
            empty = np.zeros(0)
            return {k: (empty > 0 if k in _BOOL_ROWS else empty)
                    for k in spec}
        buf = self._cat.view(self._rows)
        if n_frames is not None:
            buf = buf[:n_frames]
        out = {}
        for i, k in enumerate(spec):
            col = buf[:, i]
            out[k] = (col > 0.5 if k in _BOOL_ROWS
                      else col.astype(np.float64))
        # first tile's left halo is synthetic silence -> spurious frame-0
        # flux; match the offline/turbo convention (onset_env[0] == 0) so
        # pick_onsets' env-max normalization sees the real peaks
        if "onset_env" in out and len(out["onset_env"]):
            out["onset_env"] = out["onset_env"].copy()
            out["onset_env"][0] = 0.0
        return out

    #: frames of recompute overlap ahead of the incremental-trend cache;
    #: every filter in the stack has far shorter memory (savgol window 11,
    #: Bollinger/RSI ~20, EMA/Kalman exponential decay — the slowest,
    #: MACD's 26-span EMA, retains 3e-9 of a value 256 frames back), so
    #: discarding this warmup makes the appended tail numerically
    #: indistinguishable from a full-track pass (parity-tested in
    #: tests/test_torch_realtime.py, which exercises W=64)
    _TREND_WARMUP = 256

    def _trend_full(self, f0_clean: np.ndarray) -> Dict[str, np.ndarray]:
        # the fast host twin of the oracle pass (bit-identical when the
        # native library is present, else falls back to the oracle's
        # Python loops)
        from aegis_tpu_torch.core import trend_fast

        fin = trend_fast.analyze_pitch_financial(f0_clean)
        return {k: np.asarray(fin[k]) for k in
                ("trend", "articulations", "slides", "confidence")}

    def _trend_incremental(self, f0_clean: np.ndarray) -> Dict[str, np.ndarray]:
        """O(new frames) trend for the LIVE poll path: the full pass is
        O(T), so polls recompute only [cache_end - warmup, T) and append
        past the warmup.  finalize() bypasses this (exact full pass)."""
        T = len(f0_clean)
        W = self._TREND_WARMUP
        cache = self._fin_trend_cache
        if cache is None or len(cache["trend"]) > T:
            out = self._trend_full(f0_clean)
        elif len(cache["trend"]) == T:
            return cache
        else:
            # the cache's LAST W frames were computed with end-of-array
            # edge semantics (the centered filters look forward), so they
            # are stale once more audio exists — drop them and recompute
            # from a further-W left warmup (recurrence state rebuild)
            c = len(cache["trend"])
            keep = max(c - W, 0)
            lo = max(keep - W, 0)
            tail = self._trend_full(f0_clean[lo:])
            out = {k: np.concatenate([cache[k][:keep], tail[k][keep - lo:]])
                   for k in cache}
        self._fin_trend_cache = out
        return out

    def _analysis(self, n_frames: Optional[int] = None,
                  exact: bool = False) -> Dict[str, np.ndarray]:
        """The accumulated rows as an offline-shaped analysis dict; for a
        financial stream, the whole-track trend stack is (re)computed here
        over everything received so far on the host — retroactively
        consistent, same semantics as the device trend stack of
        core/trend.py (parity-tested in tests/test_torch_trend.py).  Polls use the
        incremental cache; ``exact=True`` (finalize) runs the full pass."""
        rows = self._stacked(n_frames)
        if not self.financial or len(rows.get("f0", ())) == 0:
            return rows
        from aegis_tpu_torch.ref import trend_ref

        T = len(rows["f0"])
        f0_clean = np.where(rows["voiced_flag"], rows["f0"],
                            np.nan).astype(np.float32)
        if exact:
            fin = self._trend_full(f0_clean)
        else:
            fin = self._trend_incremental(f0_clean)
            fin = {k: v[:T] for k, v in fin.items()}
        high = float(np.sum(rows.pop("dist_high_sum")))
        total = float(np.sum(rows.pop("dist_total_sum")))
        rows.update(
            trend=fin["trend"],
            artic_codes=np.asarray(fin["articulations"], np.int8),
            slide_codes=np.asarray(fin["slides"], np.int8),
            financial_confidence=fin["confidence"],
        )
        if exact:
            # offline-shape extras, for parity with the offline analyze
            # dict.  The poll path skips them: extract_events_financial
            # recomputes combined confidence + the adaptive threshold
            # internally, so computing them per poll was pure dead work
            # on the O(T) hot path.
            combined = rows["voiced_probs"] * 0.5 + fin["confidence"] * 0.5
            n_mels = self.audio.n_mels
            hi_bins = n_mels - int(n_mels * 0.7)
            # use_guitar_filters=False forces distortion_score to 0.0, the
            # same convention as analyze_financial_program and the turbo
            # paths
            dist = ((high / (T * hi_bins)) / (total / (T * n_mels) + 1e-6)
                    if self.use_guitar_filters and total else 0.0)
            rows.update(
                combined_confidence=combined,
                adaptive_threshold=trend_ref.adaptive_confidence_threshold(
                    combined),
                distortion_score=dist,
            )
        return rows

    def _extract(self, rows: Dict[str, np.ndarray], *,
                 onsets: Optional[np.ndarray] = None,
                 threshold: Optional[float] = None,
                 phase_a_only: bool = False,
                 rms_ref: Optional[float] = None,
                 rms_floor_db: Optional[float] = None) -> List[dict]:
        """Full extraction (finalize / cache-miss path).  ``phase_a_only``
        stops before the GLOBAL passes (density-RSI ghost filter and the
        harmonic key/context section) — the horizon poll re-applies those
        per poll over the spliced event list (_phase_b), because their
        decisions read the whole track (the RSI recurrence runs from bin
        0; the key is detected from every event)."""
        if self.financial:
            from aegis_tpu_torch.core.events import extract_events_financial

            kw = dict(self.extract_kwargs)
            ct = kw.pop("confidence_threshold", None)
            if ct is None:
                ct = threshold
            harmonic = kw.pop("use_harmonic_filter", True)
            ghost = kw.pop("ghost_rsi", True)
            events, _info = extract_events_financial(
                rake_mask=rows["rake_mask"], f0=rows["f0"],
                voiced_flag=rows["voiced_flag"],
                active_probs=rows["voiced_probs"], rms=rows["rms"],
                sr=self.audio.sample_rate,
                hop_length=self.audio.hop_length,
                trend=rows["trend"], artic_codes=rows["artic_codes"],
                slide_codes=rows["slide_codes"],
                financial_confidence=rows["financial_confidence"],
                confidence_threshold=ct,
                onset_env=rows["onset_env"]
                if kw.pop("use_onsets", True) else None,
                onsets=onsets,
                ghost_rsi=ghost and not phase_a_only,
                use_harmonic_filter=harmonic and not phase_a_only,
                rms_ref=rms_ref, rms_floor_db=rms_floor_db,
                **kw)
            return events
        from aegis_tpu_torch.core.events import extract_events_v1

        return extract_events_v1(
            rake_mask=rows["rake_mask"], f0=np.nan_to_num(rows["f0"]),
            voiced_flag=rows["voiced_flag"], active_probs=rows["voiced_probs"],
            rms=rows["rms"], sr=self.audio.sample_rate,
            hop_length=self.audio.hop_length,
            onset_env=rows.get("onset_env")
            if self.extract_kwargs.get("use_onsets", True) else None,
            onsets=onsets, rms_ref=rms_ref, rms_floor_db=rms_floor_db,
            hammer_pairs=not phase_a_only,
            **{k: v for k, v in self.extract_kwargs.items()
               if k != "use_onsets"})

    def _phase_b(self, events: List[dict],
                 threshold: Optional[float]) -> List[dict]:
        """The financial extractor's global passes, applied per poll over
        the full spliced list (mirrors extract_events_financial's tail:
        track split -> density-RSI gate -> harmonic key/context)."""
        if not self.financial:
            from aegis_tpu_torch.core.events import _hammer_pull_pairs

            _hammer_pull_pairs(events, 1000.0 * self.audio.hop_length
                               / self.audio.sample_rate)
            return events
        from aegis_tpu_torch.core.events import (apply_harmonic_context,
                                           filter_ghost_notes_rsi)

        kw = self.extract_kwargs
        thr = kw.get("confidence_threshold")
        if thr is None:
            thr = threshold if threshold is not None else 0.5
        # _build_events' track split, re-derived from the stored (pre-
        # context) confidence so frozen events follow the current adaptive
        # threshold exactly as a full re-extraction would
        for e in events:
            e["track"] = "main" if e["confidence"] >= thr else "safe"
        if kw.get("ghost_rsi", True) and len(events) > 10:
            events = filter_ghost_notes_rsi(
                events, self.audio.sample_rate, self.audio.hop_length,
                kw.get("rsi_threshold", 70.0))
        if kw.get("use_harmonic_filter", True) and len(events) > 5:
            events, _ = apply_harmonic_context(
                events, self.audio.sample_rate, self.audio.hop_length,
                thr, kw.get("harmonic_tolerance", 1))
        return events

    def _poll_full(self) -> List[dict]:
        """Cache-free poll (the horizon's equality reference; tests)."""
        rows = self._analysis()
        if len(rows.get("f0", ())) == 0:
            return []
        return self._extract(rows, threshold=self._poll_threshold(rows))

    def _poll_threshold(self, rows) -> Optional[float]:
        if not self.financial:
            return None
        from aegis_tpu_torch.ref import trend_ref

        combined = (np.asarray(rows["voiced_probs"]) * 0.5
                    + np.asarray(rows["financial_confidence"]) * 0.5)
        return trend_ref.adaptive_confidence_threshold(combined)

    def poll_events(self) -> List[dict]:
        """Events over everything analyzed so far (the live view — same
        instant re-filter contract as the offline Phase 2).  After
        finalize(), polls serve the finalized rows.

        Poll cost is bounded by the finalized-event horizon: raw events
        behind a validated freeze cut are cached and only the active tail
        re-extracts (module header; equality with the cache-free poll is
        pinned by tests/test_torch_realtime.py)."""
        with phase("live.poll"):
            return self._poll_events()

    def _poll_events(self) -> List[dict]:
        if self._final_rows is not None:
            rows = self._final_rows
            if len(rows.get("f0", ())) == 0:
                return []
            return self._extract(rows)
        rows = self._analysis()
        T = len(rows.get("f0", ()))
        if T == 0:
            return []
        kw = self.extract_kwargs
        if not kw.get("use_onsets", True) or kw.get("onset_fwd_snap_ms", 0.0):
            # no-onset / forward-snap configs bypass the horizon (the
            # neural tail-ghost pass walks event pairs sequentially)
            return self._extract(rows, threshold=self._poll_threshold(rows))
        from aegis_tpu_torch.core.cqt import pick_onsets_incremental
        from aegis_tpu_torch.ref.dsp_ref import amplitude_to_db

        sr, hop = self.audio.sample_rate, self.audio.hop_length
        onsets, self._onset_state = pick_onsets_incremental(
            np.asarray(rows["onset_env"], np.float64), sr, hop,
            self._onset_state)
        thr = self._poll_threshold(rows)
        # track-global dB reference + clamp floor: the extractors' rms_db
        # (and hence the noise gate / activation) reference the track max,
        # so windowed tail extraction must pin both to the global values
        rms_raw = np.asarray(rows["rms"])
        rms_db = amplitude_to_db(rms_raw)
        rms_ref = float(np.max(rms_raw)) if len(rms_raw) else 0.0
        rms_floor = float(np.max(rms_db)) - 80.0 if len(rms_raw) else -80.0
        fps = sr / hop
        qa = max(int(kw.get("onset_snap_ms", 140.0) / 1000.0 * fps),
                 int(kw.get("sustain_ms", 50.0) / 1000.0 * fps)) + 2
        if 2 * qa > _HZN_PRE:
            return self._extract(rows, threshold=thr)

        c = self._hzn
        fp = (rms_ref,)  # a new loudest frame re-references every dB read
        raw = None
        if (c is not None and T >= c["T"] and fp == c.get("fp")
                and np.array_equal(onsets[onsets < c["cut"]],
                                   c["onsets_pre"])):
            R = max(c["cut"] - _HZN_PRE, 0)
            tail_rows = {k: (v[R:] if getattr(v, "ndim", 0) else v)
                         for k, v in rows.items()}
            t_ev = self._extract(tail_rows, onsets=onsets - R,
                                 threshold=thr, phase_a_only=True,
                                 rms_ref=rms_ref, rms_floor_db=rms_floor)
            t_ev = [e for e in _shift_events(t_ev, R)
                    if e["start"] >= c["cut"]]
            raw = c["frozen"] + t_ev
        if raw is None:
            # stale or absent cache: full Phase-A extraction, fresh cache
            self._hzn = c = None
            raw = self._extract(rows, onsets=onsets, threshold=thr,
                                phase_a_only=True,
                                rms_ref=rms_ref, rms_floor_db=rms_floor)
        # financial: the incremental trend rewrites its last _TREND_WARMUP
        # frames on every poll, so events reading those frames are not
        # final yet — push the freeze cut behind the rewrite window
        hi = T - _HZN_K - (self._TREND_WARMUP if self.financial else 0)
        lo = c["cut"] if c is not None else 0
        # mono cut: event-level — valid exactly where no (post-snap) event
        # CHAIN spans b (contiguous same-note pieces share their pre-split
        # parent's attributes; see _span_cross_fn); segmentation/merge/
        # snap stability across polls follows from the fingerprint + the
        # onsets prefix + the K margins
        gap = int(kw.get("sustain_ms", 50.0) / 1000.0 * fps)
        cut = _find_cut(onsets, lo=max(hi - 1024, lo), hi=hi, quiet=0,
                        cross_fn=_span_cross_fn(raw, chain_gap=gap))
        if cut is not None and (c is None or cut >= c["cut"]):
            self._hzn = {"T": T, "cut": cut, "fp": fp,
                         "frozen": [dict(e) for e in raw
                                    if e["end"] < cut],
                         "onsets_pre": onsets[onsets < cut]}
        return self._phase_b([dict(e) for e in raw], thr)

    def finalize(self) -> List[dict]:
        """Flush the buffered tail (padding it with silence, the offline
        trailing-pad convention) and return the final event list.
        Idempotent: repeat calls re-extract from the finalized rows."""
        if self._final_rows is None:
            true_frames = self.audio.n_frames(self._n_fed)
            remaining = true_frames - self.frames_analyzed
            if remaining > 0:
                need_tiles = -(-remaining // self.turbo.tile_frames)
                pad = need_tiles * self._tile_samp + 2 * self._ctx
                self.feed(np.zeros(pad, np.float32))
                self._n_fed -= pad  # padding is not audio
            self._final_rows = self._analysis(true_frames, exact=True)
        rows = self._final_rows
        if len(rows.get("f0", ())) == 0:
            return []
        return self._extract(rows)


# --------------------------------------------------------------------------
# Polyphonic live streaming
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _poly_tile_program(sr: int, n_fft: int, hop: int, n_mels: int,
                       n_bins: int, bins_per_octave: int, max_voices: int,
                       tile: int, halo: int,
                       device: torch.device = torch.device("cpu")):
    """One poly tile program per (config, device): (STFT slab and RMS slab
    as one (2, span) int16 upload, running mel ref) -> raw-voice rows
    [bins|sals|rms|onset|cqt_f16] + updated ref (the trailing columns are
    the f16-packed raw CQT magnitude plane feeding the host octave-recovery
    pass, same layout as the offline packed program).

    The per-tile work is engine.turbo.poly_tile_rows at M = 1 with the
    realtime adaptations of the v1 _tile_program: the onset envelope's dB
    reference is the RUNNING mel-power maximum, carried on the device (a
    live source cannot see the future; the flux difference cancels the
    reference except at the -80 dB floor), while the voice-acceptance
    global peak is applied on the HOST at poll time over everything
    received so far, so a finalized stream reproduces the offline fused
    program's roll exactly."""
    from aegis_tpu_torch.core.tables import poly_tables
    from aegis_tpu_torch.engine.turbo import poly_tile_rows

    tables = poly_tables(sr, n_fft, n_bins, bins_per_octave, n_mels, device)

    def program(slabs16: torch.Tensor, scale: float,
                ref_power: torch.Tensor):
        with phase("aegis.live_poly_tile"):
            y = slabs16.to(torch.float32) * scale
            rows, new_ref = poly_tile_rows(
                y[0:1], y[1:2], hop, tile, halo, tables, max_voices,
                lambda interior_max: torch.maximum(ref_power, interior_max))
            return rows[0], new_ref

    return program


class StreamingPolyTranscriber:
    """Online chunk-fed POLYPHONIC transcription (chords, live input).

    Same feed/poll/finalize contract as StreamingTranscriber, built on the
    raw-voice poly transport: the device ships (bins, saliences) per frame
    and the host reconstructs the piano roll at poll time with the
    global-so-far acceptance peak — retroactively exact, so
    ``finalize()`` events equal the offline ``AegisPolyEngine`` pipeline
    on the same audio (tested).  The first tile's left STFT context is the
    track-head reflection (the offline pad convention), built once the
    first samples arrive.  Runs on the card unless the caller names
    ``device="cpu"``; without a card the default raises.
    """

    def __init__(self, sample_rate: int = 22050,
                 n_fft: Optional[int] = None,
                 hop_length: Optional[int] = None, n_bins: int = 84,
                 bins_per_octave: int = 12, max_voices: int = 6,
                 n_mels: int = 128,
                 tile_frames: int = 24, halo_frames: int = 8,
                 device="cuda", **extract_kwargs):
        from aegis_tpu_torch.engine.poly import AegisPolyEngine

        # sr-proportional window defaults, same rule as AegisPolyEngine
        self._engine = AegisPolyEngine(sample_rate=sample_rate, n_fft=n_fft,
                                       hop_length=hop_length, n_bins=n_bins,
                                       bins_per_octave=bins_per_octave,
                                       max_voices=max_voices, device=device)
        self.device = self._engine.device
        n_fft, hop_length = self._engine.n_fft, self._engine.hop_length
        self.sr, self.n_fft, self.hop = sample_rate, n_fft, hop_length
        self.n_bins, self.bpo = n_bins, bins_per_octave
        self.max_voices, self.n_mels = max_voices, n_mels
        self.tile, self.halo = tile_frames, halo_frames
        self.extract_kwargs = extract_kwargs
        self._ctx = halo_frames * hop_length + n_fft // 2
        self._tile_samp = tile_frames * hop_length
        self._buf = np.zeros(0, np.float32)   # raw samples, trimmed
        self._buf_off = 0                     # absolute index of _buf[0]
        self._tile_idx = 0
        self._rows: List[np.ndarray] = []     # per-tile (tile, 2V+2+cqt/2)
        self._hzn: Optional[dict] = None      # finalized-event horizon
        self._onset_state = None              # incremental onset pick
        self._cat = _RowCat()                 # append-only row concat
        # running mel-power dB reference, kept on the device between tiles
        self._ref_power = torch.zeros(1, dtype=torch.float32,
                                      device=self.device)
        self._n_fed = 0
        self._finalized = False
        self._final_analysis: Optional[Dict] = None

    # ------------------------------------------------------------------ props

    @property
    def lookahead_s(self) -> float:
        return (self._tile_samp + self._ctx) / float(self.sr)

    @property
    def frames_analyzed(self) -> int:
        return len(self._rows) * self.tile

    # ------------------------------------------------------------------ feed

    def feed(self, chunk: np.ndarray) -> int:
        """Append PCM samples; analyzes every tile whose right halo is
        complete.  Returns the number of tiles analyzed by this call."""
        if self._finalized:
            raise RuntimeError("stream already finalized; feed() is no "
                               "longer accepted")
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, chunk])
        self._n_fed += len(chunk)
        done = 0
        while True:
            start = self._tile_idx * self._tile_samp
            if self._buf_off + len(self._buf) < start + self._tile_samp \
                    + self._ctx:
                break
            self._run_tile(start)
            self._tile_idx += 1
            done += 1
            # trim: the next tile needs samples from (its start - ctx)
            keep_from = self._tile_idx * self._tile_samp - self._ctx
            drop = max(keep_from - self._buf_off, 0)
            if drop:
                self._buf = self._buf[drop:]
                self._buf_off += drop
        return done

    def _run_tile(self, start: int) -> None:
        core = self._buf[start - self._buf_off:
                         start - self._buf_off + self._tile_samp + self._ctx]
        if self._tile_idx == 0:
            # track-head left context: reflection for STFT frames (the
            # offline frame_signal pad convention, via the SAME helper the
            # offline turbo path uses), zeros for RMS frames
            left_s = reflect_head(core, self._ctx, self.n_fft // 2)
            left_z = np.zeros(self._ctx, np.float32)
        else:
            left = self._buf[start - self._ctx - self._buf_off:
                             start - self._buf_off]
            left_s = left_z = left
        slab_s = np.concatenate([left_s, core])
        slab_z = np.concatenate([left_z, core])
        program = _poly_tile_program(self.sr, self.n_fft, self.hop,
                                     self.n_mels, self.n_bins, self.bpo,
                                     self.max_voices, self.tile, self.halo,
                                     self.device)
        s16, sc = quantize_pcm16(slab_s)
        # same int16 grid for both slabs (left pads are zeros or copies of
        # the same samples, so one scale covers both exactly)
        z16 = np.round(slab_z / sc).astype(np.int16) if sc else \
            np.zeros_like(slab_z, np.int16)
        # one upload for the two slabs, one device->host copy for the rows;
        # the reference stays on the device
        rows, self._ref_power = program(
            upload(np.stack([s16, z16]), self.device),
            float(np.float32(sc)), self._ref_power)
        self._rows.append(rows.cpu().numpy())

    # ------------------------------------------------------------------ read

    def _analysis(self, n_frames: Optional[int] = None) -> Optional[Dict]:
        if not self._rows:
            return None
        buf = self._cat.view(self._rows)
        if n_frames is not None:
            buf = buf[:n_frames]
        out = unpack_poly_voices(buf, self.max_voices, self.bpo)
        out["onset_env"][0] = 0.0  # first-frame convention (lag pad)
        return out

    def _poll_full(self) -> List[dict]:
        """Cache-free poll (the horizon's equality reference; tests)."""
        analysis = self._analysis()
        if analysis is None:
            return []
        return self._engine.extract_events(analysis, **self.extract_kwargs)

    def poll_events(self) -> List[dict]:
        """Events over everything analyzed so far (live view).  After
        finalize(), polls serve the finalized analysis.

        Poll cost is bounded by the finalized-event horizon (module
        header): events behind a validated freeze cut are cached, only
        the active tail re-runs segmentation + the recovery chain, and
        the track-global scalars every pass reads (salience acceptance
        peak, RMS silence reference, raw-CQT peak, picked onsets) are
        computed over the full history and passed in as overrides — a
        fingerprint change (a new loudest attack) invalidates the cache.
        Equality with the cache-free poll is pinned by
        tests/test_torch_realtime.py."""
        if self._finalized:
            if self._final_analysis is None:
                return []
            return self._engine.extract_events(self._final_analysis,
                                               **self.extract_kwargs)
        if not self._rows:
            return []
        kw = self.extract_kwargs
        if not kw.get("use_onsets", True):
            return self._poll_full()
        from aegis_tpu_torch.core.cqt import pick_onsets_incremental
        from aegis_tpu_torch.ref.dsp_ref import amplitude_to_db

        buf = self._cat.view(self._rows)
        V = self.max_voices
        T = buf.shape[0]
        # track-global scalars, computed exactly as the full extraction
        # derives them (same dtypes and elementwise ops)
        sal_peak = float(np.max(buf[:, V:2 * V].astype(np.float32)))
        rms_raw = buf[:, 2 * V].astype(np.float64)
        rms_db = amplitude_to_db(rms_raw)
        rms_ref = float(np.max(rms_raw))
        rms_peak_db = float(np.max(rms_db))
        env = buf[:, 2 * V + 1].astype(np.float64)
        env[0] = 0.0  # first-tile halo convention (_analysis)
        onsets, self._onset_state = pick_onsets_incremental(
            env, self.sr, self.hop, self._onset_state)
        plane = np.ascontiguousarray(buf[:, 2 * V + 2:])
        mag_max = np.float32(plane.view(np.float16).max())
        track_peak_db = float(np.max(
            20.0 * np.log10(np.maximum(
                np.array([mag_max], np.float32), 1e-12))))
        # rms_ref (the RAW rms max) is the dB reference — rms_peak_db is
        # identically 0 under self-referencing, so the raw max is what
        # actually detects a new loudest frame
        fp = (sal_peak, rms_ref, track_peak_db)
        live = rms_db >= (rms_peak_db - kw.get("silence_db", 45.0))
        fps = self.sr / self.hop
        gap = int(kw.get("sustain_ms", 120.0) / 1000.0 * fps)
        qa = max(gap, int(kw.get("snap_back_ms", 200.0) / 1000.0 * fps),
                 _HZN_QUIET) + 2
        if 2 * qa > _HZN_PRE:
            # pathological kwargs (huge merge/snap windows): the margins
            # no longer cover them — serve the cache-free path
            return self._poll_full()

        over = dict(kw)
        over.update(rms_peak_db=rms_peak_db, track_peak_db=track_peak_db,
                    rms_ref=rms_ref, rms_floor_db=rms_peak_db - 80.0)
        c = self._hzn
        events = None
        # poly activation for the cut test = the silence-gated roll over
        # whatever window was unpacked (the tail always covers the scan
        # range, which sits above the previous cut)
        roll_g, roll_off = None, 0
        if (c is not None and T >= c["T"] and fp == c["fp"]
                and np.array_equal(onsets[onsets < c["cut"]],
                                   c["onsets_pre"])):
            R = max(c["cut"] - _HZN_PRE, 0)
            tail = unpack_poly_voices(buf[R:], V, self.bpo,
                                      global_peak=sal_peak)
            if R == 0:
                tail["onset_env"][0] = 0.0
            roll_g = np.asarray(tail["roll"], bool) & live[R:, None]
            roll_off = R
            t_ev = self._engine.extract_events(tail, onsets=onsets - R,
                                               **over)
            t_ev = [e for e in _shift_events(t_ev, R)
                    if e["start"] >= c["cut"]]
            events = c["frozen"] + t_ev
        if events is None:
            self._hzn = c = None
            analysis = unpack_poly_voices(buf, V, self.bpo,
                                          global_peak=sal_peak)
            analysis["onset_env"][0] = 0.0
            roll_g = np.asarray(analysis["roll"], bool) & live[:, None]
            events = self._engine.extract_events(analysis, onsets=onsets,
                                                 **over)
        hi = T - _HZN_K
        lo = c["cut"] if c is not None else 0
        span_cross = _span_cross_fn(events)

        def _poly_cross(b):
            # a final event spans b, or some note's gated-roll run could
            # merge across b (same-note activity within the sustain gap
            # on both sides)
            if span_cross(b):
                return True
            i = b - roll_off
            left = roll_g[max(i - gap - 1, 0):i]
            right = roll_g[i:i + gap + 1]
            return bool((left.any(axis=0) & right.any(axis=0)).any())

        cut = _find_cut(onsets, lo=max(hi - 1024, lo), hi=hi, quiet=0,
                        cross_fn=_poly_cross,
                        event_starts=[e["start"] for e in events])
        if cut is not None and (c is None or cut >= c["cut"]):
            self._hzn = {"T": T, "cut": cut, "fp": fp,
                         "frozen": [dict(e) for e in events
                                    if e["end"] < cut],
                         "onsets_pre": onsets[onsets < cut]}
        return [dict(e) for e in events]

    def finalize(self, output_mid=None, **kwargs) -> List[dict]:
        """Flush the buffered tail (silence padding, the offline trailing
        convention) and return the final event list — identical to the
        offline AegisPolyEngine events on the same audio.  Idempotent:
        repeat calls re-extract from the finalized analysis."""
        if not self._finalized:
            true_frames = 1 + self._n_fed // self.hop
            remaining = true_frames - self.frames_analyzed
            if remaining > 0:
                need_tiles = -(-remaining // self.tile)
                pad = need_tiles * self._tile_samp + 2 * self._ctx
                self.feed(np.zeros(pad, np.float32))
                self._n_fed -= pad  # padding is not audio
            self._final_analysis = self._analysis(true_frames)
            self._finalized = True
        if self._final_analysis is None:
            return []
        return self._engine.extract_events(
            self._final_analysis, output_mid,
            **{**self.extract_kwargs, **kwargs})
