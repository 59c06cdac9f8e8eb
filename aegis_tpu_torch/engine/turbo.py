"""Turbo: tiled execution for long audio and track batches (PyTorch).

Counterpart of ``aegis_tpu/engine/turbo.py``: the v1 and financial tiled,
batch and streamed programs and the tiled polyphonic program.
The JAX package runs a ``shard_map`` over a (data, time) device mesh.  In
one process both mesh axes are batch dimensions of ONE program over
(B tracks, n_tiles tiles):

  * the audio is cut into fixed tiles of ``tile_frames`` frames with
    ``halo_frames`` of context on each side; every tile runs the analyze
    stages (mel → rake → pYIN → RMS) and the halo frames are dropped on
    merge, so the HMM has warm context at every seam.  The pYIN stages see
    all B*n_tiles haloed tiles as one batch: one launch of each Viterbi
    kernel, one CTA a tile.
  * the ``ppermute`` halo exchange becomes overlapping slabs cut (``unfold``)
    from the track zero-padded by the halo context, which is exactly the
    global center / tail padding;
  * the ``pmax`` dB reference is a max over ONE track's tiles, never across
    the batch (a quiet track keeps its own reference);
  * the ``psum`` of the distortion partial sums is a sum over the track's
    tiles; the ``all_gather`` of the trend rows is a reshape.

Every program also takes a ``mesh`` (``utils/mesh.py``): a (data, time)
grid of ranks over ``torch.distributed``, one process a rank.  Each rank
runs the same program on its block (B / data tracks, n_tiles / time
tiles); its first and last tile take their halos from the neighbouring
ranks, the dB reference is a ``pmax`` over the time row, the distortion
sums add in rank order, the trend rows are all-gathered over the time
row, and the packed output over the world, so every rank returns the
whole answer.  Without a mesh, in an initialized world, the programs take
every rank as the JAX package takes every device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.core import masks, trend
from aegis_tpu_torch.core.analyze import (_FIN_ROWS, _GTR_ROWS, _INT_ROWS,
                                          _V1_ROWS, PCM8_BLOCK, _unpack,
                                          check_transport, quantize_pcm8,
                                          quantize_pcm16, quantize_tracks,
                                          upload)
from aegis_tpu_torch.core.cqt import onset_from_db
from aegis_tpu_torch.core.pyin import pyin_from_frames
from aegis_tpu_torch.core.tables import Tables, tables_from_numpy
from aegis_tpu_torch.utils.mesh import SOLO, Mesh, resolve_mesh
from aegis_tpu_torch.utils.prof import phase


def _slab_span(tile_frames: int, halo: int, hop: int, frame_length: int) -> int:
    return (tile_frames + 2 * halo - 1) * hop + frame_length


# --------------------------------------------------------------------------
# Per-tile program (every tile of every track as one batch)
# --------------------------------------------------------------------------

def _frame_slab(slab: torch.Tensor, n_frames: int, hop: int, frame_len: int,
                offset: int) -> torch.Tensor:
    """Overlapping frames (..., n_frames, frame_len) of slabs (..., S), as
    contiguous slice+reshape copies when frame_len % hop == 0 (the
    framing of dsp.frame_signal), else a strided window view."""
    x = slab[..., offset:]
    if frame_len % hop == 0:
        k = frame_len // hop
        need = (n_frames + k - 1) * hop
        if need > x.shape[-1]:
            x = F.pad(x, (0, need - x.shape[-1]))
        parts = [x[..., i * hop:(i + n_frames) * hop].reshape(
            x.shape[:-1] + (n_frames, hop)) for i in range(k)]
        return torch.cat(parts, dim=-1)
    return x.unfold(-1, frame_len, hop)[..., :n_frames, :]


def _tile_mel_power(slab: torch.Tensor, audio: AudioConfig,
                    pyin_cfg: PyinConfig, turbo: TurboConfig,
                    tables: Tables) -> torch.Tensor:
    """(M, T2, n_mels) mel power for M slabs (T2 = tile + 2*halo frames)."""
    hop, fl, n_fft = audio.hop_length, pyin_cfg.frame_length, audio.n_fft
    t2 = turbo.tile_frames + 2 * turbo.halo_frames
    # STFT frames: window n_fft centered at frame*hop + fl//2 within the
    # slab (the slab already includes the center padding offset)
    frames = _frame_slab(slab, t2, hop, n_fft, (fl - n_fft) // 2)
    frames = frames * tables.window
    re = frames @ tables.dft_cos
    im = frames @ tables.dft_sin
    return (re * re + im * im) @ tables.mel_fb_t


def _tile_analyze(slab: torch.Tensor, mel_db: torch.Tensor, rake_sens: float,
                  audio: AudioConfig, pyin_cfg: PyinConfig,
                  turbo: TurboConfig, tables: Tables,
                  financial: bool = False,
                  use_guitar_filters: bool = True) -> Dict[str, torch.Tensor]:
    """pYIN + RMS + rake for M slabs (M, span), cropped to the tile
    interiors: every row comes back (M, tile).

    With ``financial=True`` the guitar-specific filters (sub-E2 correction,
    rake enhancement, palm-mute mask) also run here, ON THE HALOED ARRAYS:
    each has bounded temporal extent (<= 50 ms: 2 frames at hop 512 and
    22 050 Hz, 4 at 44 100 Hz), so cropping afterwards is exact for any halo
    of 5 frames or more: the 64-frame halo of the tiled modes and the
    8-frame halo of the live transcriber's default preset alike (a run that
    reaches the slab's edge has more than 5 frames in the halo alone and is
    rejected for its length either way).  The
    whole-track trend recurrences do not run per tile (see
    analyze_audio_sharded)."""
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    tile, halo = turbo.tile_frames, turbo.halo_frames
    t2 = tile + 2 * halo

    frames = _frame_slab(slab, t2, hop, fl, 0)
    f0, voiced, probs = pyin_from_frames(frames, audio.sample_rate, pyin_cfg,
                                         tables)
    rms_ = torch.sqrt(torch.mean(frames * frames, dim=-1))
    rake = masks.detect_rake(mel_db, hop, audio.sample_rate, rake_sens)
    # flux over the haloed tile so the lagged diff is seam-exact
    onset_env = onset_from_db(mel_db)

    sl = slice(halo, halo + tile)
    out = {}
    if financial:
        if use_guitar_filters:
            f0, voiced = masks.filter_subharmonic(f0, voiced, fmin_hz=82.4)
            rake = masks.enhance_rake(mel_db, hop, audio.sample_rate, rake)
            mute = masks.detect_palm_mute(mel_db, hop, audio.sample_rate)
            voiced = voiced & ~mute
            out["mute_mask"] = mute[:, sl]
        else:
            out["mute_mask"] = torch.zeros_like(voiced[:, sl])
        # distortion_score partial sums PER INTERIOR FRAME, reduced over the
        # track's tiles (tiled) or on the host over the slabs (streamed)
        hi = int(mel_db.shape[-1] * 0.7)
        out["dist_high_sum"] = torch.sum(mel_db[:, sl, hi:], dim=-1)
        out["dist_total_sum"] = torch.sum(mel_db[:, sl], dim=-1)
    out.update({
        "f0": f0[:, sl],
        "voiced_flag": voiced[:, sl],
        "voiced_probs": probs[:, sl],
        "rms": rms_[:, sl],
        "rake_mask": rake[:, sl],
        "mel_db": mel_db[:, sl],
        "onset_env": onset_env[:, sl],
    })
    return out


# --------------------------------------------------------------------------
# The tiled program over (B tracks, n_tiles tiles)
# --------------------------------------------------------------------------

def _block(x: Optional[torch.Tensor], m, b: int, cols: int = 0):
    """The rank's block of a global array: its ``b`` rows on the data axis
    and, with ``cols``, its ``cols`` columns on the time axis."""
    if x is None:
        return None
    x = x[m.data_index * b:(m.data_index + 1) * b]
    return x[:, m.time_index * cols:(m.time_index + 1) * cols] if cols else x


def _assemble(parts, m) -> torch.Tensor:
    """Every rank's (b, k_local, ...) block, in rank order -> (B, n_tiles,
    ...): time blocks side by side, data blocks stacked."""
    return torch.cat([torch.cat(parts[d * m.time:(d + 1) * m.time], dim=1)
                      for d in range(m.data)], dim=0)


def tile_slabs(y16: torch.Tensor, scale: torch.Tensor, audio: AudioConfig,
               pyin_cfg: PyinConfig, turbo: TurboConfig, n_tiles: int,
               edge16: Optional[torch.Tensor] = None,
               edge_scale: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Dequantized haloed slabs (b * k_local, span), track-major, of the
    rank's block of B tracks (all of them without a mesh): the halo
    exchange of the JAX package's ``ppermute`` as overlapping windows of
    the block padded by the halo context on both sides, from the
    neighbours on the time row (``Mesh.halo``) and at the track's ends
    zeros, the global center / tail padding, or real audio from
    ``edge16``."""
    m = mesh or SOLO
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    tile, halo = turbo.tile_frames, turbo.halo_frames
    ctx = halo * hop + fl // 2  # halo context per side
    B, s_len = y16.shape
    b, k_local, s_local = B // m.data, n_tiles // m.time, s_len // m.time
    y_loc = _block(y16, m, b, s_local)
    sc = _block(scale, m, b, s_local // PCM8_BLOCK if scale.dim() == 2 else 0)
    if sc.dim() == 2:  # int8 block-float
        y_f = (y_loc.to(torch.float32).reshape(b, -1, PCM8_BLOCK)
               * sc[:, :, None]).reshape(b, s_local)
    else:
        y_f = y_loc.to(torch.float32) * sc[:, None]
    edge = _block(edge16, m, b)
    if edge is not None:
        # streamed slabs splice REAL neighbouring audio (always int16 with a
        # per-track scale) instead of the zero-fill track-edge convention
        e_sc = _block(edge_scale, m, b) if sc.dim() == 2 else sc
        e_l = edge[:, :ctx].to(torch.float32) * e_sc[:, None]
        e_r = edge[:, ctx:].to(torch.float32) * e_sc[:, None]
    else:
        e_l = e_r = torch.zeros((b, ctx), dtype=torch.float32,
                                device=y16.device)
    left, right = m.halo(y_f[:, :ctx], y_f[:, -ctx:])
    y_ext = torch.cat([e_l if left is None else left, y_f,
                       e_r if right is None else right], dim=1)
    # slab j starts at (j*tile - halo)*hop - fl//2 in block coordinates,
    # which is y_ext[j*tile*hop]
    return y_ext.unfold(1, _slab_span(tile, halo, hop, fl), tile * hop)[
        :, :k_local].reshape(b * k_local, -1)


def analyze_audio_sharded(
    y16: torch.Tensor,  # (B, n_tiles*tile*hop) int16 / int8 / float32 PCM
    scale: torch.Tensor,
    rake_sens: float,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    turbo: TurboConfig,
    n_tiles: int,
    include_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    guitar_only: bool = False,
    peak_only: bool = False,
    edge16: Optional[torch.Tensor] = None,   # (B, 2*ctx) int16: real slab-edge
                                             # context (streamed mode); None =
                                             # the zero-fill track-edge convention
    db_ref: Optional[torch.Tensor] = None,   # (B,) mel-power dB reference; None
                                             # = each track's own max (ref=max)
    edge_scale: Optional[torch.Tensor] = None,  # (B,) int16 scale for edge16
                                             # when ``scale`` is the 2-D int8
                                             # block-scale plane
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """The tiled analyze of B tracks: one batched program, or on a (data,
    time) ``mesh`` of ranks the rank's block of (B / data tracks,
    n_tiles / time tiles) with the JAX package's collectives.

    ``scale`` is (B,) per-track (int16 / float32) or the (B, S/PCM8_BLOCK)
    int8 block-scale plane.  Returns ONE packed (B, n_tiles, tile,
    [n_mels +] len(rows)) float32 buffer (columns: optional mel_db, then
    _V1_ROWS / _GTR_ROWS / _FIN_ROWS), the whole of it on every rank —
    unpack with _unpack; with ``peak_only`` only each track's mel-power
    peak over the tile interiors, (B,).

    The halo context of a rank's first and last tile comes from its
    neighbours on the time row (``Mesh.halo``); the row's ends take zeros,
    the global center / tail padding, or real audio from ``edge16``.  The
    per-track dB reference is a MAX over the track's tiles, a ``pmax`` over
    the time row only, never across the batch (a quiet track keeps its own
    reference).

    ``financial=True`` runs the v2 pipeline: the guitar filters per haloed
    tile (exact, see _tile_analyze) and the whole-track trend stack
    (consensus, Bollinger, MACD) over each track's full-length f0 row,
    all-gathered over the time row and run replicated — identical op order
    on identical full-length input, so no halo argument is needed; the
    distortion partial sums add in rank order.  The per-track scalars
    (adaptive threshold, distortion score) ride along broadcast per frame.
    """
    m = mesh or SOLO
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    tile, halo = turbo.tile_frames, turbo.halo_frames
    ctx = halo * hop + fl // 2  # halo context per side
    B = y16.shape[0]
    if B % m.data or n_tiles % m.time:
        raise ValueError(f"{B} tracks x {n_tiles} tiles do not divide over a "
                         f"({m.data}, {m.time}) mesh")
    b, k_local = B // m.data, n_tiles // m.time
    if mesh is not None and ctx > k_local * tile * hop:
        raise ValueError(
            f"halo context ({ctx} samples) exceeds a device's local block "
            f"({k_local * tile * hop} samples): the one-hop ppermute cannot "
            f"fetch it. Increase tile_frames or reduce halo_frames/mesh "
            f"time-axis size.")
    tables = tables_from_numpy(audio, pyin_cfg, y16.device)
    flat = tile_slabs(y16, scale, audio, pyin_cfg, turbo, n_tiles, edge16,
                      edge_scale, mesh)

    mel_power = _tile_mel_power(flat, audio, pyin_cfg, turbo, tables)
    if peak_only:
        # pass 1 of the streamed mode: the slab's mel-power peak over the
        # tile INTERIORS (halo copies equal their interior twins)
        t2 = tile + 2 * halo
        interior = mel_power.reshape(b, k_local, t2, -1)[:, :, halo:halo + tile]
        peak = m.pmax_time(torch.amax(interior, dim=(1, 2, 3)))
        return torch.cat(m.gather_world(peak)[::m.time])
    # PER-TRACK dB reference (power_to_db ref=max): the max over this
    # track's tiles, never across the batch
    gmax = (_block(db_ref, m, b) if db_ref is not None
            else m.pmax_time(torch.amax(mel_power.reshape(b, -1), dim=1)))
    gmax_t = torch.repeat_interleave(gmax, k_local)[:, None, None]
    amin = 1e-10
    log_spec = 10.0 * torch.log10(torch.clamp_min(mel_power, amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp_min(gmax_t, amin))
    mel_db = torch.clamp_min(log_spec, -80.0)

    out = _tile_analyze(flat, mel_db, rake_sens, audio, pyin_cfg, turbo,
                        tables, financial=financial or guitar_only,
                        use_guitar_filters=use_guitar_filters)

    if financial:
        L = k_local * tile  # frames per rank
        f0_clean = torch.where(out["voiced_flag"], out["f0"],
                               float("nan")).reshape(b, L)
        # full-track rows on every rank of the time row
        f0_full = m.all_gather_time(f0_clean, dim=1)
        probs_full = m.all_gather_time(out["voiced_probs"].reshape(b, L),
                                       dim=1)
        with phase("aegis.trend"):
            fin = trend.analyze_pitch_financial(f0_full)
            combined = probs_full * 0.5 + fin["confidence"] * 0.5
            thr = trend.adaptive_confidence_threshold(combined)  # (b,)

        # distortion_score from the tile-interior partial sums of each
        # track, added in rank order over the time row
        n_mels = audio.n_mels
        hi_bins = n_mels - int(n_mels * 0.7)
        t_full = n_tiles * tile
        high = m.psum_time(out["dist_high_sum"].reshape(b, -1).sum(1))
        tot = m.psum_time(out["dist_total_sum"].reshape(b, -1).sum(1))
        dist = (high / (t_full * hi_bins)) / (tot / (t_full * n_mels) + 1e-6)
        if not use_guitar_filters:
            dist = torch.zeros_like(dist)  # as analyze_financial_program

        def local(x):  # the rank's slice of a full-track row, tile-major
            return x[:, m.time_index * L:(m.time_index + 1) * L].reshape(
                b * k_local, tile)

        def per_frame(x):  # per-track scalar -> every frame of its tiles
            return torch.repeat_interleave(x, k_local)[:, None].expand(
                b * k_local, tile)

        out["trend"] = local(fin["trend"])
        out["artic_codes"] = local(fin["articulations"])
        out["slide_codes"] = local(fin["slides"])
        out["financial_confidence"] = local(fin["confidence"])
        out["combined_confidence"] = local(combined)
        out["adaptive_threshold"] = per_frame(thr)
        out["distortion_score"] = per_frame(dist)

    rows = _FIN_ROWS if financial else _GTR_ROWS if guitar_only else _V1_ROWS
    cols = [out[k].to(torch.float32)[..., None] for k in rows]
    head = [out["mel_db"]] if include_mel else []
    packed = torch.cat(head + cols, dim=-1)
    packed = packed.reshape((b, k_local) + packed.shape[1:])
    return _assemble(m.gather_world(packed), m)


TILED_TRANSPORTS = ("int16", "float32")


def _tiled_inputs(ys: np.ndarray, n_samp: int, transport: str,
                  device: torch.device):
    """(B, n) tracks -> device PCM (B, n_samp) and (B,) scales."""
    check_transport(transport, TILED_TRANSPORTS)
    if transport == "int16":
        y_dev, scale = quantize_tracks(np.asarray(ys, np.float32), n_samp)
    else:
        y_dev = np.zeros((len(ys), n_samp), np.float32)
        y_dev[:, : ys.shape[1]] = np.asarray(ys, np.float32)
        scale = np.ones(len(ys), np.float32)
    return upload(y_dev, device), upload(scale, device)


def run_analyze_turbo(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    turbo: Optional[TurboConfig] = None,
    transport: str = "int16",
    fetch_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Single-track tiled analyze: tile the track and stitch the interiors
    back together.  Output schema matches core.analyze.run_analyze (with
    the int16 PCM transport; transport="float32" for bit-exact ingest).
    financial=True returns the _FIN_ROWS schema.  On a ``mesh`` the tiles
    spread over its time axis; in an initialized world with no mesh, over
    every rank (``default_mesh(time_only=True)``)."""
    mesh, device = resolve_mesh(mesh, device, time_only=True)
    return {k: (v[0] if getattr(v, "ndim", 0) else v) for k, v in
            run_analyze_batch(np.asarray(y, np.float32)[None], audio, pyin_cfg,
                              rake_sensitivity, turbo, fetch_mel, transport,
                              financial, use_guitar_filters, device,
                              mesh=mesh).items()}


def run_analyze_batch(
    ys: np.ndarray,  # (B, n_samples) equal-length tracks
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    turbo: Optional[TurboConfig] = None,
    fetch_mel: bool = True,
    transport: str = "int16",
    financial: bool = False,
    use_guitar_filters: bool = True,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Batched multi-track tiled analyze: all B x n_tiles tiles in one
    program, or over a (data, time) ``mesh`` of ranks (tracks over the
    data axis, tiles over the time axis; the tile count rounds up to a
    multiple of the time axis, as the JAX package's does).  In an
    initialized world with no mesh, every rank on a (gcd(world, B), ...)
    grid.  Rows come back (B, T); the per-track scalars of the financial
    schema come back (B,).  transport="float32" skips the int16
    quantization for bit-exact ingest."""
    turbo = turbo or TurboConfig()
    mesh, device = resolve_mesh(mesh, device, batch=len(ys))
    n_time = mesh.time if mesh is not None else 1
    tile = turbo.tile_frames
    true_frames = audio.n_frames(ys.shape[1])
    n_tiles = max(1, -(-true_frames // tile))
    n_tiles = -(-n_tiles // n_time) * n_time
    n_samp = n_tiles * tile * audio.hop_length
    y_dev, scale = _tiled_inputs(ys, n_samp, transport, device)
    packed = analyze_audio_sharded(
        y_dev, scale, rake_sensitivity, audio, pyin_cfg, turbo, n_tiles,
        include_mel=fetch_mel, financial=financial,
        use_guitar_filters=use_guitar_filters, mesh=mesh)
    buf = packed.cpu().numpy()
    buf = buf.reshape(buf.shape[0], -1, buf.shape[-1])[:, :true_frames]
    rows = _FIN_ROWS if financial else _V1_ROWS
    result = _unpack(buf, rows, audio.n_mels if fetch_mel else 0)
    # the first tile's left halo is synthetic silence; match the fused
    # convention onset_env[0] == 0
    result["onset_env"][:, 0] = 0.0
    return result


# --------------------------------------------------------------------------
# Tiled polyphonic program (CQT salience peeling over (tracks, tiles))
# --------------------------------------------------------------------------

def poly_tile_rows(slab_s: torch.Tensor, slab_z: torch.Tensor, hop: int,
                   tile: int, halo: int, tables, max_voices: int,
                   ref_power):
    """The per-tile polyphonic work on M haloed slabs (M, span): STFT power
    ONCE for the CQT and the mel projection, RMS, the peel, the onset flux
    on the haloed tile (seam-exact for any halo >= 1 frame), cropped to the
    tile interiors.

    ``slab_s`` feeds the STFT frames and ``slab_z`` the RMS frames: they
    differ only where a slab's left context is the head of the track
    (reflection for the STFT, the ``frame_signal`` pad; zeros for the RMS).
    ``ref_power`` maps the (M,) interior mel-power maxima to the (M,) dB
    reference of the onset envelope.  Returns (packed rows (M, tile, C) in
    the layout of core.poly.pack_poly_rows, the dB reference (M,))."""
    from aegis_tpu_torch.core.poly import pack_poly_rows, peel_voices

    n_fft = tables.window.shape[0]
    t2 = tile + 2 * halo
    sl = slice(halo, halo + tile)
    fr = _frame_slab(slab_s, t2, hop, n_fft, 0) * tables.window
    re = fr @ tables.dft_cos
    im = fr @ tables.dft_sin
    power = re * re + im * im
    cqt_p = (power @ tables.cqt_fb_t)[:, sl]
    mel_p = power @ tables.mel_fb_t
    frz = _frame_slab(slab_z, t2, hop, n_fft, 0)[:, sl]
    rms_ = torch.sqrt(torch.mean(frz * frz, dim=-1))
    # the peel is frame-local: peeling the interiors alone is exact
    bins_v, sals_v = peel_voices(cqt_p, tables.supp, tables.sub, max_voices)

    ref = ref_power(torch.amax(mel_p[:, sl], dim=(1, 2)))
    amin = 1e-10
    mel_db = (10.0 * torch.log10(torch.clamp_min(mel_p, amin))
              - 10.0 * torch.log10(torch.clamp_min(ref, amin))[:, None, None])
    mel_db = torch.clamp_min(mel_db, -80.0)
    onset = onset_from_db(mel_db)[:, sl]
    return pack_poly_rows(bins_v, sals_v, rms_, onset, cqt_p), ref


def analyze_poly_sharded(
    y16: torch.Tensor,     # (B, n_tiles*tile*hop) int16 PCM
    scale: torch.Tensor,   # (B,) dequant scales
    edge16: torch.Tensor,  # (B, 2*ctx) int16 track-edge context: the host's
                           # reflect padding on the left (STFT pad_mode),
                           # zeros on the right (past the padded tail)
    hop: int, max_voices: int, tables, n_tiles: int, tile: int, halo: int,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """The polyphonic Perception Phase (core.poly.analyze_poly_program) of B
    tracks as ONE batched program over (tracks, tiles), or over a (data,
    time) ``mesh`` of ranks, each on its (B / data, n_tiles / time) block.

    Per-frame work (CQT projection, harmonic peeling, RMS, onset flux) is
    local to a haloed tile.  A rank's halos come from its neighbours on the
    time row (``Mesh.halo``); at the track's ends each of the two edge
    conventions is spliced in: the STFT slabs have the reflected head on
    the left of tile 0, the RMS slabs zeros; both have zeros past the right
    end.  The only cross-tile state is one per-track scalar, the mel-power
    dB reference of the onset envelope: a max over ONE track's tile
    interiors (a ``pmax`` over the time row), never across the batch.
    Returns ONE packed (B, n_tiles, tile, 2*max_voices + 2 +
    ceil(n_bins/2)) buffer of raw voices plus the f16-packed raw CQT
    magnitude plane, the whole of it on every rank; the host reconstructs
    the roll / confidence / salience planes through the NumPy oracle with
    the track-global acceptance peak (max over the shipped saliences)."""
    from aegis_tpu_torch.core.poly import cqt_plane_cols

    m = mesh or SOLO
    n_fft = tables.window.shape[0]
    span = _slab_span(tile, halo, hop, n_fft)
    ctx = halo * hop + n_fft // 2
    B, s_len = y16.shape
    if B % m.data or n_tiles % m.time:
        raise ValueError(f"{B} tracks x {n_tiles} tiles do not divide over a "
                         f"({m.data}, {m.time}) mesh")
    b, k_local = B // m.data, n_tiles // m.time
    if mesh is not None and ctx > k_local * tile * hop:
        raise ValueError(
            f"halo context ({ctx} samples) exceeds a device's local block "
            f"({k_local * tile * hop} samples); increase tile_frames or "
            f"reduce halo_frames/mesh time-axis size.")
    sc = _block(scale, m, b)
    y_f = _block(y16, m, b, s_len // m.time).to(torch.float32) * sc[:, None]
    edge = _block(edge16, m, b)
    e_l = edge[:, :ctx].to(torch.float32) * sc[:, None]
    e_r = edge[:, ctx:].to(torch.float32) * sc[:, None]
    zero = torch.zeros_like(e_l)
    left, right = m.halo(y_f[:, :ctx], y_f[:, -ctx:])

    def slabs(edge_l, edge_r):
        y_ext = torch.cat([edge_l if left is None else left, y_f,
                           edge_r if right is None else right], dim=1)
        return y_ext.unfold(1, span, tile * hop)[:, :k_local].reshape(
            b * k_local, span)

    def track_ref(interior_max):  # (b*k_local,) -> each track's own max
        gmax = m.pmax_time(torch.amax(interior_max.reshape(b, k_local), dim=1))
        return torch.repeat_interleave(gmax, k_local)

    packed, _ = poly_tile_rows(slabs(e_l, e_r), slabs(zero, zero), hop, tile,
                               halo, tables, max_voices, track_ref)
    n_bins = tables.cqt_fb_t.shape[1]
    assert packed.shape[-1] == 2 * max_voices + 2 + cqt_plane_cols(n_bins)
    packed = packed.reshape((b, k_local) + packed.shape[1:])
    return _assemble(m.gather_world(packed), m)


def run_analyze_poly_turbo(
    ys: np.ndarray,  # (n_samples,) one track or (B, n_samples) equal-length
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    max_voices: int = 6,
    n_mels: int = 128,
    turbo: Optional[TurboConfig] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Tiled polyphonic analyze: tile every track and stitch the tile
    interiors.  Output schema matches AegisPolyEngine.analyze: {roll,
    confidence, salience, rms, onset_env, cqt_mag}, batched along axis 0
    when ``ys`` is 2-D.  On a (data, time) ``mesh`` of ranks, tracks over
    the data axis and tiles over the time axis (the tile count rounds up
    to a multiple of it); in an initialized world with no mesh, every
    rank: on the time axis for one track, on a (gcd(world, B), ...) grid
    for a batch."""
    from aegis_tpu_torch.core.analyze import reflect_head
    from aegis_tpu_torch.core.poly import unpack_poly_voices
    from aegis_tpu_torch.core.tables import poly_tables

    single = ys.ndim == 1
    ys2 = np.asarray(ys, np.float32)[None] if single else np.asarray(
        ys, np.float32)
    mesh, device = resolve_mesh(mesh, device,
                                batch=None if single else len(ys2))
    n_time = mesh.time if mesh is not None else 1
    turbo = turbo or TurboConfig()
    tile, halo = turbo.tile_frames, turbo.halo_frames
    ctx = halo * hop_length + n_fft // 2
    true_frames = 1 + ys2.shape[1] // hop_length
    n_tiles = max(1, -(-true_frames // tile))
    n_tiles = -(-n_tiles // n_time) * n_time
    n_samp = n_tiles * tile * hop_length

    y16, scale = quantize_tracks(ys2, n_samp)
    # left context = the track's reflect padding (same int16 samples, so the
    # dequantized slab equals frame_signal's reflect pad exactly); shared
    # helper with the live poly transcriber (core.analyze.reflect_head)
    edge = np.zeros((len(ys2), 2 * ctx), np.int16)
    edge[:, :ctx] = reflect_head(y16, ctx, n_fft // 2,
                                 true_len=ys2.shape[1])

    tables = poly_tables(sr, n_fft, n_bins, bins_per_octave, n_mels, device)
    with phase("aegis.poly_program"):
        packed = analyze_poly_sharded(
            upload(y16, device), upload(scale, device), upload(edge, device),
            hop_length, max_voices, tables, n_tiles, tile, halo, mesh=mesh)
    buf = packed.cpu().numpy()
    buf = buf.reshape(buf.shape[0], -1, buf.shape[-1])[:, :true_frames]
    # per-track plane reconstruction through the oracle; the acceptance
    # peak is per-track (max over that track's shipped saliences), matching
    # the fused single-track program exactly
    tracks = [unpack_poly_voices(buf[i], max_voices, bins_per_octave)
              for i in range(buf.shape[0])]
    out = {k: np.stack([t[k] for t in tracks]) for k in tracks[0]}
    out["onset_env"][:, 0] = 0.0  # first-frame convention (lag pad)
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out


# --------------------------------------------------------------------------
# Streamed long-track mode (bounded device/host memory)
# --------------------------------------------------------------------------

def _trend_full_program(f0_clean: torch.Tensor, probs: torch.Tensor,
                        high_sum: float, total_sum: float, n_frames_f: float,
                        hi_bins: int, n_mels: int) -> Dict[str, torch.Tensor]:
    """Whole-track financial trend rows over the streamed f0: ONE small
    pass over (T,) rows (the heavy per-sample work already ran slab by
    slab)."""
    fin = trend.analyze_pitch_financial(f0_clean)
    combined = probs * 0.5 + fin["confidence"] * 0.5
    thr = trend.adaptive_confidence_threshold(combined)
    dist = (high_sum / (n_frames_f * hi_bins)) / (
        total_sum / (n_frames_f * n_mels) + 1e-6)
    return {
        "trend": fin["trend"],
        "artic_codes": fin["articulations"],
        "slide_codes": fin["slides"],
        "financial_confidence": fin["confidence"],
        "combined_confidence": combined,
        "adaptive_threshold": thr,
        "distortion_score": torch.tensor(dist, dtype=torch.float32),
    }


def run_analyze_streamed(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    turbo: Optional[TurboConfig] = None,
    slab_tiles: Optional[int] = None,
    financial: bool = False,
    use_guitar_filters: bool = True,
    fetch_mel: bool = False,
    fetch_group: int = 8,
    transport: str = "int8",
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Bounded-memory tiled analyze for multi-minute tracks.

    The track is processed in fixed slabs of ``slab_tiles`` tiles through
    the same tiled program as run_analyze_turbo; device memory is bounded
    by the slab size regardless of duration, and the host accumulates only
    the per-frame output rows (~40 B/frame with fetch_mel=False).

    Exactness vs run_analyze_turbo:
      * slab edges splice REAL neighbouring audio via ``edge16`` (no
        synthetic-zero seams), so every tile computes on the same haloed
        window as the unstreamed program;
      * the track-global dB reference (power_to_db ref=max) comes from a
        pass 1 over the mel power only, kept on the device and passed as
        ``db_ref`` so rake / palm-mute thresholds agree in every slab;
      * for financial=True the per-tile guitar filters stream with the
        slabs and the whole-track trend stack runs afterwards in one small
        pass over the assembled f0 row.

    ``fetch_group``: pass-2 slab outputs are fetched in groups of this many
    through one device-side concat each.  ``transport``: "int8" (default)
    ships the slabs as block-float int8, the same PCM8_BLOCK grid from
    sample 0 as the fused int8 path; slab edges stay int16 with the
    per-track scale.  "int16" keeps the bit-exact-vs-run_analyze_turbo
    contract; int8 falls back to int16 when the slab length is not a
    block multiple (tile*hop < 1024 configurations).

    On a ``mesh`` (in an initialized world with none: every rank on the
    time axis) each slab's tiles spread over the time axis: 16 tiles a
    rank by default, the slab rounded to a multiple of the time axis as
    the JAX package rounds it; pass 1's interior peak is a ``pmax`` over
    the time row.
    """
    turbo = turbo or TurboConfig()
    mesh, device = resolve_mesh(mesh, device, time_only=True)
    n_time = mesh.time if mesh is not None else 1
    tile, halo = turbo.tile_frames, turbo.halo_frames
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    ctx = halo * hop + fl // 2

    true_frames = audio.n_frames(len(y))
    n_tiles_total = max(1, -(-true_frames // tile))
    # 16 tiles a rank is the JAX package's measured default; never pad a
    # short track past its own tile count (rounded to the mesh)
    slab_tiles = slab_tiles or 16 * n_time
    slab_tiles = -(-slab_tiles // n_time) * n_time
    slab_tiles = min(slab_tiles, -(-n_tiles_total // n_time) * n_time)
    slab_samp = slab_tiles * tile * hop
    n_slabs = max(1, -(-n_tiles_total // slab_tiles))
    n_samp = n_slabs * slab_samp

    if transport == "int8" and slab_samp % PCM8_BLOCK == 0:
        y_pad = np.zeros(n_samp, np.float32)
        y_pad[: len(y)] = np.asarray(y, np.float32)
        q8, bscales = quantize_pcm8(y_pad)
        q8, bscales = q8[None], bscales[None]
        nblk = slab_samp // PCM8_BLOCK
        y16, esc = quantize_pcm16(y_pad)
        y16 = y16[None]
        slabs_np = [q8[:, s * slab_samp: (s + 1) * slab_samp]
                    for s in range(n_slabs)]
        scales_np = [bscales[:, s * nblk: (s + 1) * nblk]
                     for s in range(n_slabs)]
        edge_scale = upload(np.array([esc], np.float32), device)
    else:
        y16, scale = quantize_tracks(np.asarray(y, np.float32)[None], n_samp)
        slabs_np = [y16[:, s * slab_samp: (s + 1) * slab_samp]
                    for s in range(n_slabs)]
        scales_np = [scale] * n_slabs
        edge_scale = None

    def _edge_np(s: int) -> np.ndarray:
        lo, hi = s * slab_samp, (s + 1) * slab_samp
        left = y16[:, max(lo - ctx, 0): lo]
        if left.shape[1] < ctx:
            left = np.pad(left, ((0, 0), (ctx - left.shape[1], 0)))
        right = y16[:, hi: hi + ctx]
        if right.shape[1] < ctx:
            right = np.pad(right, ((0, 0), (0, ctx - right.shape[1])))
        return np.concatenate([left, right], axis=1)

    # upload each slab ONCE and reuse it in both passes
    slabs_dev = [upload(a, device) for a in slabs_np]
    scales_dev = [upload(a, device) for a in scales_np]
    edges_dev = [upload(_edge_np(s), device) for s in range(n_slabs)]

    # pass 1: the track-global mel-power reference, reduced on the device
    peaks = [analyze_audio_sharded(
        slabs_dev[s], scales_dev[s], rake_sensitivity, audio, pyin_cfg, turbo,
        slab_tiles, peak_only=True, edge16=edges_dev[s],
        edge_scale=edge_scale, mesh=mesh) for s in range(n_slabs)]
    gmax = torch.amax(torch.cat(peaks)).reshape(1)

    # pass 2: the full analyze per slab; outputs fetched in groups
    rows = _GTR_ROWS if financial else _V1_ROWS
    n_mels = audio.n_mels if fetch_mel else 0
    fetch_group = max(1, fetch_group)
    outs, pending = [], []

    def fetch_batch(hs) -> np.ndarray:
        buf = (hs[0] if len(hs) == 1
               else torch.cat(hs, dim=1)).cpu().numpy()[0]
        return buf.reshape(-1, buf.shape[-1])

    for s in range(n_slabs):
        pending.append(analyze_audio_sharded(
            slabs_dev[s], scales_dev[s], rake_sensitivity, audio, pyin_cfg,
            turbo, slab_tiles, include_mel=fetch_mel, guitar_only=financial,
            use_guitar_filters=use_guitar_filters, edge16=edges_dev[s],
            db_ref=gmax, edge_scale=edge_scale, mesh=mesh))
        if len(pending) >= fetch_group:
            outs.append(fetch_batch(pending))
            pending = []
    if pending:
        outs.append(fetch_batch(pending))
    buf = np.concatenate(outs, axis=0)  # (n_slabs*slab_frames, C)
    del outs

    high_sum = total_sum = 0.0
    if financial:
        # the last two columns carry PER-FRAME distortion partial sums,
        # summed over the full padded window, the convention of every mode
        sums = buf[:, n_mels + len(rows) - 2:]
        high_sum, total_sum = sums.sum(axis=0)
        buf = buf[:, : n_mels + len(rows) - 2]
        rows = rows[:-2]

    full = _unpack(buf, rows, n_mels)
    t_pad = buf.shape[0]
    result = {k: v[:true_frames] for k, v in full.items()}
    result["onset_env"][0] = 0.0  # synthetic first-tile halo convention

    if financial:
        f0c = np.where(full["voiced_flag"], full["f0"], np.nan).astype(np.float32)
        probs = np.asarray(full["voiced_probs"], np.float32)
        n_mels_a = audio.n_mels
        hi_bins = n_mels_a - int(n_mels_a * 0.7)
        if not use_guitar_filters:
            high_sum = total_sum = 0.0  # distortion_score -> 0
        fin = _trend_full_program(
            upload(f0c, device), upload(probs, device),
            np.float32(high_sum), np.float32(total_sum), np.float32(t_pad),
            hi_bins, n_mels_a)
        for k, v in fin.items():
            arr = v.cpu().numpy()
            if arr.ndim == 0:
                result[k] = np.float32(arr)
            elif k in _INT_ROWS:
                result[k] = arr[:true_frames].astype(_INT_ROWS[k])
            else:
                result[k] = arr[:true_frames]
    return result
