"""Check and time the CUDA Viterbi kernels on one NVIDIA GPU.

    python -m aegis_tpu_torch.tools.bench_viterbi [--quick]
        [--baseline first/viterbi.cu] [--previous earlier/viterbi.cu]
        [--shapes name,name] [--out results.jsonl]

For each shape of the main path (one 60 s track fused at 22 050 and 44 100
Hz, the auto router's v1 half at 44 100 Hz on hop 1024, its tiles, the
stream's slab of 16 tiles, the live transcriber's one tile a launch: B = 1,
T = 40 and 128) and a few edge shapes (T = 1,
T = 2, n < 2w + 1, a table too large for shared memory, the finer pitch
grids n = 900, 1125 and 2250) it runs every
variant of the forward kernel (both destination tiles, one to eight CTAs a
sequence, the score table in shared or global memory) and the backtrace against the plain PyTorch versions on
synthetic observations: backpointers, final delta and states must be
identical.  Then it times them with CUDA events (warm medians of 5).

``--baseline`` names the source of an earlier version of the kernels with
the first C interface (``aegis_viterbi_fwd`` reading the (n, 2w+1) band,
``aegis_viterbi_back`` with one thread a sequence), for example
``git show <commit>:aegis_tpu_torch/csrc/viterbi.cu > build/viterbi_v1.cu``;
``--previous`` names one with the present C interface.  Either is built
beside the present library and timed in turns with it (earlier, new, new,
earlier), since only times taken in one run on one card compare.
``--quick`` checks the short shapes only and times nothing; ``--shapes``
keeps the named shapes only (``live`` stands for the four live shapes).
Every timed shape lists the cluster variants beside the one-CTA ones.

The checks also run the forward kernel on scores the engines never make
(an observation of exactly 0, observations above 0, frames of -inf), where
its results must still be the plain version's.

Prints one JSON object a line; the first names the card and its power
limit.  Exits non-zero when there is no CUDA device or a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import PyinConfig
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import band_class_table, log_transition_band
from aegis_tpu_torch.tools.signal_gen import wandering_pitch_obs

CFG = PyinConfig()
LOG_STAY = float(np.log1p(-CFG.switch_prob))
LOG_SWITCH = float(np.log(CFG.switch_prob))

# name: (B, T, n, w, checked against the plain versions in --quick too)
SHAPES = {
    "t1": (1, 1, 450, 101, True),
    "t2": (2, 2, 450, 51, True),
    "short_w101": (1, 70, 450, 101, True),
    "short_b3_w51": (3, 131, 450, 51, True),
    "narrow_n150_w101": (2, 65, 150, 101, True),   # n < 2w + 1
    "wide_w200": (1, 40, 450, 200, True),          # table past shared memory
    # one live tile a launch: tile + 2 * halo frames at the (24, 8) and the
    # (64, 32) presets, both rates
    "live_t40_w101": (1, 40, 450, 101, True),
    "live_t128_w101": (1, 128, 450, 101, True),
    "live_t40_w51": (1, 40, 450, 51, True),
    "live_t128_w51": (1, 128, 450, 51, True),
    "fused60_22050": (1, 2625, 450, 101, False),
    "fused60_44100": (1, 5249, 450, 51, False),
    # the auto router's v1 half at 44 100 Hz, hop 1024: the 60 s bucket
    "auto60_44100": (1, 2625, 450, 101, False),
    "tiles60_22050": (3, 1152, 450, 101, False),
    "tiles60_44100": (6, 1152, 450, 51, False),
    "stream_slab": (16, 1152, 450, 101, False),
    "batch_40": (40, 300, 450, 101, False),   # 4 B CTAs outnumber the SMs
    # finer pitch grids (PyinConfig.resolution 0.05, 0.04, 0.02): the wide
    # kernel, its table in shared memory (n = 900, 1125) or global memory
    "grid_n900_w101": (1, 60, 900, 101, True),
    "grid_n1125_w126_b6": (6, 50, 1125, 126, True),
    "grid_n2250_w501_b16": (16, 30, 2250, 501, True),
}
LIVE = ("live_t40_w101", "live_t128_w101", "live_t40_w51", "live_t128_w51")
TIMED = ("fused60_22050", "fused60_44100", "auto60_44100", "tiles60_22050",
         "tiles60_44100", "stream_slab", "batch_40") + LIVE


def emit(out, obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def cuda_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` runs of fn(), timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def synthetic_inputs(B: int, T: int, n: int, dev, seed: int = 100,
                     drift: int = 7):
    """(log_obs_v, log_obs_u) of B wandering-pitch sequences on ``dev``."""
    pairs = [wandering_pitch_obs(T, n, seed + b, min(200, n // 2) + drift * b,
                                 8, (-2, -1, 0, 1, 2), True) for b in range(B)]
    obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(dev)
    vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(dev)
    return (torch.log(obs + 1e-30).contiguous(),
            torch.log((1.0 - vprob) / n + 1e-30).contiguous())


def band_and_table(n: int, w: int, dev):
    """The (n, 2w+1) transition band and its class table on ``dev``."""
    band_np = log_transition_band(n, w)
    return (torch.from_numpy(band_np).to(dev),
            torch.from_numpy(band_class_table(band_np, n, w)).to(dev))


def forward_variant(lo_v, lo_u, tab, n, w, tile, cluster, in_smem=True,
                    lib=None):
    """One variant of the forward kernel, past the wrapper's choice."""
    return pyin_cuda._launch_fwd(
        lo_v, lo_u, tab, n, w, LOG_STAY, LOG_SWITCH, tile, cluster,
        pyin_cuda.max_shared_memory(lo_v.device) if in_smem else 0, lib)


class Baseline:
    """An earlier version of the kernels, through its own C interface."""

    def __init__(self, source: str):
        self.lib = ctypes.CDLL(str(pyin_cuda.build(source)))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.aegis_viterbi_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                               f, f, f, f, p]
        self.lib.aegis_viterbi_back.argtypes = [p, p, p, p, i, i, i, p]

    def fwd(self, lo_v, lo_u, band, tab, n, w):
        B, T, _ = lo_v.shape
        psi_v = torch.empty((B, T, n), dtype=torch.int32, device=lo_v.device)
        psi_u = torch.empty_like(psi_v)
        d_last = torch.empty((B, 2, n), dtype=torch.float32,
                             device=lo_v.device)
        err = self.lib.aegis_viterbi_fwd(
            lo_v.data_ptr(), lo_u.data_ptr(), band.data_ptr(),
            psi_v.data_ptr(), psi_u.data_ptr(), d_last.data_ptr(), B, T, n, w,
            float(np.log(1.0 / (2 * n))), float(pyin_cuda.LOG_FLOOR),
            LOG_STAY, LOG_SWITCH, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline viterbi_fwd: cudaError {err}")
        return psi_v, psi_u, d_last

    def back(self, d_last, psi_v, psi_u):
        B, T, n = psi_v.shape
        states = torch.empty((B, T), dtype=torch.int32, device=psi_v.device)
        err = self.lib.aegis_viterbi_back(
            d_last.data_ptr(), psi_v.data_ptr(), psi_u.data_ptr(),
            states.data_ptr(), B, T, n,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline viterbi_back: cudaError {err}")
        return states


class Previous:
    """An earlier source of the kernels with the present C interface, run
    with the variant the wrapper picks."""

    def __init__(self, source: str):
        self.lib = pyin_cuda._bind(pyin_cuda.build(source))

    def fwd(self, lo_v, lo_u, band, tab, n, w):
        launch = pyin_cuda.pick_forward_variant(
            lo_v.shape[0], torch.cuda.get_device_properties(
                lo_v.device).multi_processor_count, n, w,
            pyin_cuda.max_shared_memory(lo_v.device))
        return forward_variant(lo_v, lo_u, tab, n, w, launch.tile,
                               launch.cluster, lib=self.lib)

    def back(self, d_last, psi_v, psi_u):
        B, T, n = psi_v.shape
        states = torch.empty((B, T), dtype=torch.int32, device=psi_v.device)
        n_chunks = max(-(-(T - 1) // pyin_cuda.BACK_CHUNK), 1)
        maps = torch.empty((B, n_chunks, 2 * n), dtype=torch.int32,
                           device=psi_v.device)
        err = self.lib.aegis_viterbi_back(
            d_last.data_ptr(), psi_v.data_ptr(), psi_u.data_ptr(),
            maps.data_ptr(), states.data_ptr(), B, T, n, pyin_cuda.BACK_CHUNK,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous viterbi_back: cudaError {err}")
        return states


def variants():
    """(name, tile, CTAs a sequence, table in shared memory)."""
    out = [(f"tile{tile}_cluster{c}", tile, c, True)
           for tile in pyin_cuda.FWD_TILES for c in pyin_cuda.FWD_CLUSTERS
           if tile != 96 or c > 1]
    return out + [("tile88_cluster1_table_global", 88, 1, False)]


def unusual_scores(lo_v, lo_u):
    """The same observations changed into scores no engine makes: one
    observation of exactly 0, all raised above 0, and frames of -inf."""
    zero_v = lo_v.clone()
    zero_v[:, lo_v.shape[1] // 2, lo_v.shape[2] // 3] = 0.0
    half_v = lo_v.clone()   # the lower half of the voiced states never scores
    half_v[:, :, : lo_v.shape[2] // 2] = -float("inf")
    frame_v, frame_u = lo_v.clone(), lo_u.clone()
    if lo_v.shape[1] > 2:   # a frame with no score at all, and all after it
        frame_v[:, 2] = -float("inf")
        frame_u[:, 2] = -float("inf")
    return {"one_zero": (zero_v, lo_u), "above_zero": (lo_v + 9.0, lo_u + 9.0),
            "minus_inf_states": (half_v, lo_u),
            "minus_inf_frame": (frame_v, frame_u)}


def check(name: str, shape, dev, out, earlier) -> None:
    B, T, n, w, _ = shape
    lo_v, lo_u = synthetic_inputs(B, T, n, dev)
    band, tab = band_and_table(n, w, dev)
    dense = pyin_cuda.dense_from_band(band, n, w)
    p_v, p_u, p_last = pyin_cuda.viterbi_fwd_plain(lo_v, lo_u, dense,
                                                   LOG_STAY, LOG_SWITCH)
    p_states = pyin_cuda.viterbi_back_plain(p_last, p_v, p_u)
    runs = {name: forward_variant(lo_v, lo_u, tab, n, w, tile, cl, smem)
            for name, tile, cl, smem in variants()}
    runs["wrapper"] = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w, LOG_STAY,
                                            LOG_SWITCH, tab)
    if earlier is not None:
        runs["earlier"] = earlier.fwd(lo_v, lo_u, band, tab, n, w)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(v[0], p_v) and torch.equal(v[1], p_u)
                    and torch.equal(v[2], p_last)) for k, v in runs.items()}
    states = pyin_cuda.viterbi_back(p_last, p_v, p_u)
    torch.cuda.synchronize()
    same["back"] = bool(torch.equal(states, p_states))
    for what, (u_v, u_u) in unusual_scores(lo_v, lo_u).items():
        plain = pyin_cuda.viterbi_fwd_plain(u_v, u_u, dense, LOG_STAY,
                                            LOG_SWITCH)
        for vname, tile, cl, smem in variants():
            got = forward_variant(u_v, u_u, tab, n, w, tile, cl, smem)
            same[f"{what}_{vname}"] = all(
                bool(torch.equal(a, b)) for a, b in zip(got, plain))
    emit(out, {"check": name, "B": B, "T": T, "n": n, "w": w,
               "identical_to_plain": same})
    if not all(same.values()):
        raise AssertionError(f"{name}: differs from the plain version: {same}")


def time_shape(name: str, shape, dev, out, earlier) -> None:
    B, T, n, w, _ = shape
    lo_v, lo_u = synthetic_inputs(B, T, n, dev)
    band, tab = band_and_table(n, w, dev)

    def new_fwd():
        return pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w, LOG_STAY,
                                     LOG_SWITCH, tab)

    def new_back():
        return pyin_cuda.viterbi_back(d_last, psi_v, psi_u)

    psi_v, psi_u, d_last = new_fwd()
    row = {"time": name, "B": B, "T": T, "n": n, "w": w}
    if earlier is not None:   # earlier, new, new, earlier
        def old_fwd():
            return earlier.fwd(lo_v, lo_u, band, tab, n, w)

        def old_back():
            return earlier.back(d_last, psi_v, psi_u)

        row["fwd_ms_earlier_new_new_earlier"] = [
            cuda_ms(fn) for fn in (old_fwd, new_fwd, new_fwd, old_fwd)]
        row["back_ms_earlier_new_new_earlier"] = [
            cuda_ms(fn) for fn in (old_back, new_back, new_back, old_back)]
    row["fwd_ms_by_variant"] = {
        vname: cuda_ms(lambda: forward_variant(lo_v, lo_u, tab, n, w, tile,
                                               cl, smem))
        for vname, tile, cl, smem in variants()}
    # the time must not depend on the scores' sign
    up_v, up_u = lo_v + 9.0, lo_u + 9.0
    row["fwd_ms_scores_above_zero"] = cuda_ms(lambda: pyin_cuda.viterbi_fwd(
        up_v, up_u, band, n, w, LOG_STAY, LOG_SWITCH, tab))
    row["back_ms"] = cuda_ms(new_back)
    row["fwd_ms_default"] = cuda_ms(new_fwd)
    row["us_per_step_default"] = 1000.0 * row["fwd_ms_default"] / max(T - 1, 1)
    emit(out, row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--previous", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    wanted = None
    if args.shapes:
        wanted = {n for part in args.shapes.split(",")
                  for n in (LIVE if part == "live" else (part,))}
        unknown = wanted - set(SHAPES)
        if unknown:
            ap.error(f"unknown shapes {sorted(unknown)}")
    dev = resolve_device("cuda")
    out = open(args.out, "w") if args.out else None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit(out, {"card": smi, "torch": torch.__version__})
    so_path = pyin_cuda.build()
    for line in so_path.with_suffix(".ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(line.strip(), flush=True)
    earlier = (Baseline(args.baseline) if args.baseline
               else Previous(args.previous) if args.previous else None)
    for name, shape in SHAPES.items():
        if (shape[4] or not args.quick) and (wanted is None or name in wanted):
            check(name, shape, dev, out, earlier)
    if not args.quick:
        for name in TIMED:
            if wanted is None or name in wanted:
                time_shape(name, SHAPES[name], dev, out, earlier)
    emit(out, {"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
