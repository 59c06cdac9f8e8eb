"""The device half of the streamed v1 reference: plain PyTorch in float64.

What a configuration's ``stream`` numbers state for a take past its
threshold, computed tile by tile.  The track (int16 samples / 32768) is
zero-padded to whole slabs of ``slab_tiles`` tiles of ``tile_frames``
frames (fewer tiles a slab where the track has fewer) and read twice: as
int8 block-float on the 1 024-sample grid from sample 0, and as int16
with the track's peak scale (``edge_transport``).  Each tile sees its
frames with ``halo_frames`` more on each side: the samples inside its own
slab from the int8 copy, those outside it from the int16 copy, zeros
before the track's start and past the last slab.  On each haloed tile:

  * the power mel spectrogram (periodic Hann, ``torch.fft.rfft``, the
    Slaney filterbank of ``v1_device``) of frames centered on the tile's
    frames, their context zeros where the tile's window has none;
  * its dB against ONE reference for the track: the largest mel power over
    the interiors of every tile of every slab, the padding tiles included,
    floored 80 dB under it;
  * the rake mask, the spectral-flux onset envelope (0 on the haloed
    tile's first frame) and the RMS of zero-padded centered frames;
  * pYIN's observations (``v1_device``'s CMNDF, troughs, Beta prior and
    scatter) and the tile's OWN max-product decode over its 2n states;

then each tile keeps its interior frames, the tiles are laid end to end,
the rows are cut to the track's frames and the onset envelope's first
frame is 0.  Tiles are computed ``slab_tiles`` at a time, so a 600 s take
fits beside the program on the card.

Where this departs from the program's arithmetic: every step after the
ingest is float64 (the program computes float32); a dequantized sample is
the float64 product of its float32 code and float32 scale (the program's
product is rounded to float32); the spectrum is ``rfft`` (the program
multiplies by DFT matrices); the YIN difference is by FFT; the decode is
the dense max-product scan of ``v1_device.viterbi`` (the program's banded
CUDA kernels, with the same tie rules).

``analyze(..., transport="int4")`` reads the slabs through the int4
block-float transport instead (the edges stay int16): the check's
control, the precision below the one the configuration states.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_torch.reference import v1_device

F64 = torch.float64


def layout(n_samples: int, cfg: Dict) -> Dict[str, int]:
    """The tiling of a take of ``n_samples`` samples: its frames, its
    tiles, the tiles a slab, the slabs, the tiles run (whole slabs,
    ``padded_tiles``), the samples a slab and in all."""
    a, st = cfg["audio"], cfg["stream"]
    hop, tile = a["hop_length"], st["tile_frames"]
    frames = 1 + n_samples // hop
    tiles = max(1, -(-frames // tile))
    slab_tiles = min(st["slab_tiles"], tiles)
    slabs = -(-tiles // slab_tiles)
    return {"frames": frames, "tiles": tiles, "slab_tiles": slab_tiles,
            "slabs": slabs, "padded_tiles": slabs * slab_tiles,
            "slab_samples": slab_tiles * tile * hop,
            "samples": slabs * slab_tiles * tile * hop}


def int16_peak(y: torch.Tensor) -> torch.Tensor:
    """The int16 copy of a float32 track at its peak scale, in float32 as
    the transport states (codes round(y * (32767 / peak)), scale
    peak / 32767); returned as float64, zeros for a silent track."""
    peak = float(y.abs().max()) if y.numel() else 0.0
    if peak <= 0:
        return torch.zeros_like(y, dtype=F64)
    q = torch.round(y * torch.tensor(32767.0 / peak, dtype=torch.float32,
                                     device=y.device))
    scale = torch.tensor(peak / 32767.0, dtype=torch.float32)
    return q.to(F64) * float(scale)


def copies(pcm: np.ndarray, cfg: Dict, device, transport: str):
    """The padded track's two copies, float64: the slabs' (int8 or int4
    block-float) and the edges' (int16 at the track's peak)."""
    ing = cfg["ingest"]
    lay = layout(len(pcm), cfg)
    block, levels = {"int8": (ing["block"], 127),
                     "int4": (ing["int4_block"], 7)}[transport]
    if lay["slab_samples"] % block:
        raise ValueError(f"{transport} slabs need whole {block}-sample "
                         f"blocks, a slab has {lay['slab_samples']}")
    if cfg["stream"]["edge_transport"] != "int16":
        raise ValueError("the streamed program's slab edges are int16")
    y = torch.zeros(lay["samples"], dtype=torch.float32, device=device)
    y[:len(pcm)] = torch.as_tensor(np.asarray(pcm, np.int16).astype(
        np.float32) / 32768.0, device=device)
    return v1_device.block_float(y, block, levels), int16_peak(y)


def windows(slab_y: torch.Tensor, edge_y: torch.Tensor, tiles: List[int],
            lay: Dict, cfg: Dict) -> torch.Tensor:
    """(len(tiles), span) haloed sample windows: tile g's window starts
    halo frames and half a frame before its first frame, and takes each
    sample from the slab copy inside g's own slab, from the edge copy
    outside it, zeros off the padded track."""
    a, p, st = cfg["audio"], cfg["pyin"], cfg["stream"]
    hop, fl = a["hop_length"], p["frame_length"]
    tile, halo = st["tile_frames"], st["halo_frames"]
    span = (tile + 2 * halo - 1) * hop + fl
    g = torch.as_tensor(tiles, device=slab_y.device)
    idx = ((g * tile - halo) * hop - fl // 2)[:, None] + torch.arange(
        span, device=slab_y.device)[None, :]
    lo = (g // lay["slab_tiles"] * lay["slab_samples"])[:, None]
    inside = (idx >= lo) & (idx < lo + lay["slab_samples"])
    on_track = (idx >= 0) & (idx < lay["samples"])
    at = idx.clamp(0, lay["samples"] - 1)
    return torch.where(inside, slab_y[at],
                       torch.where(on_track, edge_y[at],
                                   torch.zeros((), dtype=F64,
                                               device=slab_y.device)))


def frame_rows(w: torch.Tensor, n_frames: int, frame: int, hop: int,
               offset: int) -> torch.Tensor:
    """(M * n_frames, frame) frames of M windows, frame i at
    offset + i * hop."""
    idx = (offset + torch.arange(n_frames, device=w.device)[:, None] * hop
           + torch.arange(frame, device=w.device)[None, :])
    return w[:, idx].reshape(-1, frame)


def mel_power(w: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(M, T2, n_mels) mel power of M haloed windows."""
    a, p, st = cfg["audio"], cfg["pyin"], cfg["stream"]
    hop, n_fft, fl = a["hop_length"], a["n_fft"], p["frame_length"]
    t2 = st["tile_frames"] + 2 * st["halo_frames"]
    fr = frame_rows(w, t2, n_fft, hop, (fl - n_fft) // 2)
    spec = torch.fft.rfft(fr * v1_device.hann(n_fft, w.device), dim=1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(v1_device.mel_filterbank(
        a["sample_rate"], n_fft, a["n_mels"]), device=w.device)
    return (power @ fb.T).reshape(w.shape[0], t2, -1)


def _batches(n: int, size: int):
    for lo in range(0, n, size):
        yield list(range(lo, min(lo + size, n)))


def analyze(pcm: np.ndarray, cfg: Dict, device,
            transport: str = "int8") -> Dict[str, np.ndarray]:
    """The v1 rows of one streamed take, as the program returns them: f0 (0
    where unvoiced), voiced_flag, voiced_probs, rms, onset_env, rake_mask,
    mel_db."""
    a, p, st = cfg["audio"], cfg["pyin"], cfg["stream"]
    sr, hop = a["sample_rate"], a["hop_length"]
    tile, halo = st["tile_frames"], st["halo_frames"]
    t2 = tile + 2 * halo
    inner = slice(halo, halo + tile)
    lay = layout(len(pcm), cfg)
    slab_y, edge_y = copies(pcm, cfg, device, transport)
    size = lay["slab_tiles"]

    # the track's one dB reference: the largest interior mel power of
    # every tile run, the padding tiles' too
    power: List[torch.Tensor] = []
    for tiles in _batches(lay["padded_tiles"], size):
        power.append(mel_power(windows(slab_y, edge_y, tiles, lay, cfg),
                               cfg))
    ref = max(float(m[:, inner].max()) for m in power)
    ref_db = 10.0 * np.log10(max(ref, 1e-10))

    nbps, n, w, min_p, max_p = v1_device.pyin_grid(p, sr, hop)
    hz = v1_device.bin_hz(p["fmin"], n, nbps)
    rows: Dict[str, List[np.ndarray]] = {k: [] for k in (
        "f0", "voiced_flag", "voiced_probs", "rms", "onset_env",
        "rake_mask", "mel_db")}
    for k, tiles in enumerate(_batches(lay["tiles"], size)):
        m = len(tiles)
        mel_db = torch.clamp_min(10.0 * torch.log10(torch.clamp_min(
            power[k][:m], 1e-10)) - ref_db, -80.0)
        flux = torch.clamp_min(mel_db[:, 1:] - mel_db[:, :-1], 0.0).mean(-1)
        onset = torch.cat([torch.zeros((m, 1), dtype=F64, device=device),
                           flux], dim=1)
        mel_h = mel_db.cpu().numpy()
        rake = np.stack([v1_device.rake_mask(mel_h[i], hop, sr,
                                             cfg["analysis"]
                                             ["rake_sensitivity"])
                         for i in range(m)])
        fr = frame_rows(windows(slab_y, edge_y, tiles, lay, cfg), t2,
                        p["frame_length"], hop, 0)
        rms = torch.sqrt(torch.mean(fr * fr, dim=1)).reshape(m, t2)
        obs, vp = v1_device.observations(
            v1_device.cmndf(fr, p["win_length"], min_p, max_p), p, sr, n,
            nbps, min_p)
        del fr
        states = v1_device.viterbi(obs.reshape(m, t2, n), vp.reshape(m, t2),
                                   n, w, p["switch_prob"])
        voiced = states < n
        f0 = np.where(voiced, hz[states % n], 0.0)
        for key, val in (("f0", f0), ("voiced_flag", voiced),
                         ("voiced_probs", vp.reshape(m, t2).cpu().numpy()),
                         ("rms", rms.cpu().numpy()),
                         ("onset_env", onset.cpu().numpy()),
                         ("rake_mask", rake), ("mel_db", mel_h)):
            rows[key].append(val[:, inner].reshape((-1,) + val.shape[2:]))
    out = {k: np.concatenate(v)[:lay["frames"]] for k, v in rows.items()}
    out["f0"] = out["f0"].astype(np.float64)
    out["onset_env"][0] = 0.0
    return out
