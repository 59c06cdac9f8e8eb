"""The device half of the live reference: the v1 rows a live session
states, in plain PyTorch float64.

A live session cuts the stream into tiles of ``tile_frames`` frames, each
analysed with ``halo_frames`` frames of context either side once its right
halo has arrived: the slab of a tile is the stream (after ``ctx`` samples
of leading silence) from the tile's first sample for ctx + tile + ctx
samples, carried at 16 bits with one peak scale a slab.  Each tile's
frames are slab[i * hop : i * hop + frame_length]; its mel dB is taken
against the running maximum of the mel power over the interiors of the
tiles so far (causal), floored at -80 dB; the rake mask and the onset flux
are computed over the haloed tile and pYIN decodes the haloed tile; then
each row is cut to the interior.  The session's rows are the interiors
side by side, the first onset value zero.  Built on ``v1_device``'s
stages; nothing comes from the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench_torch.reference import v1_device

F64 = torch.float64


def slab_pcm(slabs: np.ndarray, levels: int, device) -> torch.Tensor:
    """(M, span) float32 slabs through the per-slab peak-scaled transport
    (32767 levels: int16; 127: int8), in float32 as the transport states;
    returned as float64."""
    peak = np.abs(slabs).max(axis=1).astype(np.float64)
    out = np.zeros(slabs.shape, np.float64)
    for i, (s, pk) in enumerate(zip(slabs, peak)):
        if pk <= 0:
            continue
        q = np.round(s * np.float32(levels / pk))
        out[i] = q.astype(np.float64) * float(np.float32(pk / levels))
    return torch.as_tensor(out, device=device)


def rows(pcm: np.ndarray, n_tiles: int, cfg: Dict, live: Dict, device,
         transport: str = "int16", batch: int = 64) -> Dict[str, np.ndarray]:
    """The session rows of the first ``n_tiles`` tiles of a take."""
    a, p = cfg["audio"], cfg["pyin"]
    sr, hop, n_fft, n_mels = (a["sample_rate"], a["hop_length"], a["n_fft"],
                              a["n_mels"])
    fl = p["frame_length"]
    tile, halo = live["tile_frames"], live["halo_frames"]
    t2 = tile + 2 * halo
    ctx = halo * hop + fl // 2
    tsamp = tile * hop
    span = 2 * ctx + tsamp
    y = np.concatenate([np.zeros(ctx, np.float32),
                        np.asarray(pcm, np.int16).astype(np.float32) / 32768.0])
    levels = {"int16": 32767, "int8": 127}[transport]
    nbps, n, w, min_p, max_p = v1_device.pyin_grid(p, sr, hop)
    fb = torch.as_tensor(v1_device.mel_filterbank(sr, n_fft, n_mels),
                         device=device)
    win = v1_device.hann(n_fft, device)
    idx = (np.arange(t2)[:, None] * hop + np.arange(fl)[None, :])
    off = (fl - n_fft) // 2
    out = {k: [] for k in ("f0", "voiced_flag", "voiced_probs", "rms",
                           "onset_env", "rake_mask")}
    ref_power = 0.0
    hz = v1_device.bin_hz(p["fmin"], n, nbps)
    for lo in range(0, n_tiles, batch):
        hi = min(lo + batch, n_tiles)
        slabs = np.stack([y[k * tsamp:k * tsamp + span] for k in range(lo, hi)])
        x = slab_pcm(slabs, levels, device)                    # (M, span)
        fr = x[:, torch.as_tensor(idx, device=device)]         # (M, t2, fl)
        st = fr[..., off:off + n_fft] * win
        spec = torch.fft.rfft(st, dim=-1)
        mel = (spec.real ** 2 + spec.imag ** 2) @ fb.T         # (M, t2, mels)
        inner = mel[:, halo:halo + tile].amax(dim=(1, 2)).cpu().numpy()
        refs = np.maximum.accumulate(np.concatenate([[ref_power], inner]))[1:]
        ref_power = float(refs[-1])
        ref_t = torch.as_tensor(refs, device=device)[:, None, None]
        mel_db = (10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
                  - 10.0 * torch.log10(torch.clamp_min(ref_t, 1e-10)))
        mel_db = torch.clamp_min(mel_db, -80.0)
        flux = torch.clamp_min(mel_db[:, 1:] - mel_db[:, :-1], 0.0).mean(dim=2)
        onset = torch.cat([torch.zeros((hi - lo, 1), dtype=F64, device=device),
                           flux], dim=1)
        mel_db_h = mel_db.cpu().numpy()
        rake = np.stack([v1_device.rake_mask(m, hop, sr,
                                             cfg["analysis"]["rake_sensitivity"])
                         for m in mel_db_h])
        flat = fr.reshape(-1, fl)
        obs, vp = v1_device.observations(
            v1_device.cmndf(flat, p["win_length"], min_p, max_p), p, sr, n,
            nbps, min_p)
        states = v1_device.viterbi(obs.reshape(hi - lo, t2, n),
                                   vp.reshape(hi - lo, t2), n, w,
                                   p["switch_prob"])
        voiced = states < n
        rms = torch.sqrt(torch.mean(fr * fr, dim=-1)).cpu().numpy()
        cut = slice(halo, halo + tile)
        out["f0"].append(np.where(voiced, hz[states % n], np.nan)[:, cut])
        out["voiced_flag"].append(voiced[:, cut])
        out["voiced_probs"].append(vp.reshape(hi - lo, t2).cpu().numpy()[:, cut])
        out["rms"].append(rms[:, cut])
        out["onset_env"].append(onset.cpu().numpy()[:, cut])
        out["rake_mask"].append(rake[:, cut])
    res = {k: (np.concatenate(v).reshape(-1) if v else np.zeros(0))
           for k, v in out.items()}
    res["voiced_flag"] = res["voiced_flag"].astype(bool)
    res["rake_mask"] = res["rake_mask"].astype(bool)
    res["f0"] = res["f0"].astype(np.float64)
    if len(res["onset_env"]):
        res["onset_env"][0] = 0.0
    return res
