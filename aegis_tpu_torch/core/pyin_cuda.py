"""The pYIN Viterbi decode as two CUDA kernels, with their plain versions.

Kernels (``aegis_tpu_torch/csrc/viterbi.cu``, CUDA C++ for sm_90a):

  * ``viterbi_fwd``  replaces ``_fwd_kernel``  of aegis_tpu/core/pyin_pallas.py
  * ``viterbi_back`` replaces ``_back_kernel`` of aegis_tpu/core/pyin_pallas.py

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor; there is no fallback between the two.  Each
kernel launch adds one to ``LAUNCHES[name]``, records its batch size B in
``LAST_BATCH[name]`` and adds B to ``SEQUENCES[name]``, so a run can show
that it went through the kernels, and with how many sequences.

The library is compiled with nvcc at first use into ``build/aegis_tpu_torch/``
under the repository root, keyed by a hash of the source and the flags,
and loaded with ctypes.  Both the build and any import of a GPU toolchain
happen inside the calls, never at import time.

All tensors carry a leading batch dimension B (one CTA per sequence):
log_obs_v (B, T, n), log_obs_u (B, T), backpointers psi_v / psi_u
(B, T, n) int32 holding the absolute predecessor state in [0, 2n) with row
0 zero, delta_last (B, 2, n), states (B, T) int32.

The forward kernel reads the transition scores from the class table of
``core/tables.py::band_class_table`` (the band without its repetitions),
which the caller passes beside the band; the plain version reads the band.
The backtrace kernels cut the frames into chunks of ``BACK_CHUNK``;
``viterbi_back_chunked_plain`` is that algorithm in PyTorch, step for step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from aegis_tpu_torch.core.tables import LOG_FLOOR, band_class_table

LAUNCHES = {"viterbi_fwd": 0, "viterbi_back": 0}
LAST_BATCH = {"viterbi_fwd": 0, "viterbi_back": 0}
# the sequences launched in all (the sum of B over the launches): equal to
# LAUNCHES where every launch had B = 1, as on the live path
SEQUENCES = {"viterbi_fwd": 0, "viterbi_back": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "viterbi.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aegis_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the forward kernel's destination tiles the library is built with
# (csrc/viterbi.cu): 88 is 8 destinations a thread and 8 lanes a tile, 96
# the same with 16 lanes, two a destination (clusters only)
FWD_TILES = (88, 96)
# the CTAs (one thread-block cluster) that share one sequence's forward pass
FWD_CLUSTERS = (1, 2, 4, 8)


def pick_forward_variant(B: int, n_sms: int) -> Tuple[int, int]:
    """(tile, cluster) for B sequences on a card of n_sms SMs, as measured
    on the H100 (tools/bench_viterbi.py; PERF.md): a few sequences spread
    over clusters of 8 CTAs with two lanes a destination; more sequences
    take clusters of 4, then 2, then one CTA each, so that all clusters
    stay resident at once."""
    if 16 * B <= n_sms:
        return 96, 8
    for cluster in (4, 2):
        if cluster * B <= n_sms:
            return 88, cluster
    return 88, 1


def max_shared_memory(dev: torch.device) -> int:
    """The bytes of shared memory one block may ask for on this card."""
    return getattr(torch.cuda.get_device_properties(dev),
                   "shared_memory_per_block_optin", 227 * 1024)


# frames a chunk of the backtrace
BACK_CHUNK = 64
# most frames one decode takes: with log-probabilities no smaller than
# LOG_FLOOR it keeps |delta| below 2^27, where the forward kernel's
# out-of-band rule is exact (csrc/viterbi.cu)
MAX_FRAMES = 1 << 20

_LIB = None


# --------------------------------------------------------------------------
# Build and binding
# --------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels cannot be built")


def build(source: Path = SOURCE) -> Path:
    """Compile the kernels' shared library if this source and these flags
    have not been built yet; return its path.  The compiler's report
    (registers, shared memory, spills) is kept beside it as ``.ptxas.txt``."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libaegis_{source.stem}_{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        so_path.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so_path)
    return so_path


def _bind(so_path: Path) -> ctypes.CDLL:
    """Load a build of the kernels and declare its C interface."""
    lib = ctypes.CDLL(str(so_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.aegis_viterbi_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                      f, f, f, f, i, i, i, p]
    lib.aegis_viterbi_fwd.restype = ctypes.c_int
    lib.aegis_viterbi_back.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.aegis_viterbi_back.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(build())
    return _LIB


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# --------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# --------------------------------------------------------------------------

def dense_from_band(band: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """(n, n) log transition log_local[i, j] from the (n, 2w+1) band:
    band[j, i - j + w] inside the band, LOG_FLOOR outside — the matrix the
    dense scan decode uses."""
    log_local = torch.full((n, n), float(LOG_FLOOR), dtype=band.dtype,
                           device=band.device)
    j = torch.arange(n, device=band.device)[:, None]
    i = j - w + torch.arange(2 * w + 1, device=band.device)[None, :]
    ok = (i >= 0) & (i < n)
    log_local[i[ok], j.expand_as(i)[ok]] = band[ok]
    return log_local


def viterbi_fwd_plain(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                      log_local: torch.Tensor, log_stay: float,
                      log_switch: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward max-plus pass over the dense (n, n) log transition, step for
    step the lax.scan of aegis_tpu/core/pyin.py::viterbi_decode.
    Returns (psi_v, psi_u, delta_last)."""
    B, T, n = log_obs_v.shape
    dev = log_obs_v.device
    log_init = float(np.log(1.0 / (2 * n)))
    init = torch.full((B, n), log_init, dtype=torch.float32, device=dev)
    dv = init + log_obs_v[:, 0]
    du = init + log_obs_u[:, :1]
    psi_v = torch.zeros((B, T, n), dtype=torch.int32, device=dev)
    psi_u = torch.zeros((B, T, n), dtype=torch.int32, device=dev)
    for t in range(1, T):
        scores_v = dv[:, :, None] + log_local
        scores_u = du[:, :, None] + log_local
        best_v = torch.argmax(scores_v, dim=1)
        best_u = torch.argmax(scores_u, dim=1)
        m_v = torch.amax(scores_v, dim=1)
        m_u = torch.amax(scores_u, dim=1)

        stay, switch = m_v + log_stay, m_u + log_switch
        take_stay = stay >= switch
        dv_new = torch.where(take_stay, stay, switch) + log_obs_v[:, t]
        psi_v[:, t] = torch.where(take_stay, best_v, best_u + n)

        sw, st = m_v + log_switch, m_u + log_stay
        take_sw = sw >= st
        du = torch.where(take_sw, sw, st) + log_obs_u[:, t:t + 1]
        psi_u[:, t] = torch.where(take_sw, best_v, best_u + n)
        dv = dv_new
    return psi_v, psi_u, torch.stack([dv, du], dim=1)


def viterbi_back_plain(delta_last: torch.Tensor, psi_v: torch.Tensor,
                       psi_u: torch.Tensor) -> torch.Tensor:
    """Backtrace: first argmax of the concatenated final delta, then the
    walk down the backpointers.  Returns states (B, T) int32."""
    B, T, n = psi_v.shape
    rows = torch.arange(B, device=psi_v.device)
    s = torch.argmax(delta_last.reshape(B, 2 * n), dim=1).to(torch.int32)
    states = torch.empty((B, T), dtype=torch.int32, device=psi_v.device)
    states[:, T - 1] = s
    for t in range(T - 1, 0, -1):
        s = torch.where(s < n, psi_v[rows, t, torch.clamp(s, max=n - 1)],
                        psi_u[rows, t, torch.clamp(s - n, min=0)])
        states[:, t - 1] = s
    return states


def _step_down(psi_v: torch.Tensor, psi_u: torch.Tensor, t: int,
               s: torch.Tensor) -> torch.Tensor:
    """One step down the backpointers: states s (B, k) at frame t -> the
    states at frame t - 1."""
    n = psi_v.shape[2]
    return torch.where(
        s < n, torch.gather(psi_v[:, t], 1, torch.clamp(s, max=n - 1).long()),
        torch.gather(psi_u[:, t], 1, torch.clamp(s - n, min=0).long()))


def viterbi_back_chunked_plain(delta_last: torch.Tensor, psi_v: torch.Tensor,
                               psi_u: torch.Tensor,
                               chunk: int = BACK_CHUNK) -> torch.Tensor:
    """The backtrace kernels' algorithm, step for step.  Chunk k spans the
    frames k C + 1 .. min((k + 1) C, T - 1).  First every chunk is walked
    down from every entry state (its map: the state at frame k C for each
    state at its top frame); then the final argmax hops down the maps to
    each chunk's entry state; then every chunk is walked again from that
    state, writing the states.  Equals ``viterbi_back_plain``."""
    B, T, n = psi_v.shape
    dev = psi_v.device
    K = -(-(T - 1) // chunk)
    tops = [min((k + 1) * chunk, T - 1) for k in range(K)]
    maps = []
    for k in range(K):
        s = torch.arange(2 * n, dtype=torch.int32, device=dev).repeat(B, 1)
        for t in range(tops[k], k * chunk, -1):
            s = _step_down(psi_v, psi_u, t, s)
        maps.append(s)
    s = torch.argmax(delta_last.reshape(B, 2 * n), dim=1, keepdim=True
                     ).to(torch.int32)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    states[:, T - 1] = s[:, 0]
    entries = [None] * K
    for k in range(K - 1, -1, -1):
        entries[k] = s
        s = torch.gather(maps[k], 1, s.long())
    for k in range(K):
        s = entries[k]
        for t in range(tops[k], k * chunk, -1):
            s = _step_down(psi_v, psi_u, t, s)
            states[:, t - 1] = s[:, 0]
    return states


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _launch_fwd(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                tab: torch.Tensor, n: int, w: int, log_stay: float,
                log_switch: float, tile: int, cluster: int, max_smem: int,
                lib: ctypes.CDLL | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch one variant of the forward kernel on checked inputs: ``tile``
    is one of ``FWD_TILES``, ``cluster`` one of ``FWD_CLUSTERS`` (the CTAs
    that share a sequence; tile 96 is built for two or more), ``max_smem``
    the bytes of shared memory a block may take (0 leaves the score table
    in global memory).  ``lib`` is another build of the same C interface.
    The results depend on none of them.  Counts nothing: ``viterbi_fwd``
    is the wrapper."""
    if tile not in FWD_TILES or cluster not in FWD_CLUSTERS:
        raise ValueError(f"tile {tile} / cluster {cluster}: not one of "
                         f"{FWD_TILES} / {FWD_CLUSTERS}")
    dev = log_obs_v.device
    B, T, _ = log_obs_v.shape
    psi_v = torch.empty((B, T, n), dtype=torch.int32, device=dev)
    psi_u = torch.empty((B, T, n), dtype=torch.int32, device=dev)
    delta_last = torch.empty((B, 2, n), dtype=torch.float32, device=dev)
    lib = library() if lib is None else lib
    with torch.cuda.device(dev):
        err = lib.aegis_viterbi_fwd(
            log_obs_v.data_ptr(), log_obs_u.data_ptr(), tab.data_ptr(),
            psi_v.data_ptr(), psi_u.data_ptr(), delta_last.data_ptr(),
            B, T, n, w, tab.shape[0], int(n < 2 * w + 1),
            float(np.log(1.0 / (2 * n))), float(LOG_FLOOR),
            log_stay, log_switch, tile, max_smem, cluster,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "viterbi_fwd")
    return psi_v, psi_u, delta_last


def viterbi_fwd(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                band: torch.Tensor, n: int, w: int, log_stay: float,
                log_switch: float, tab: torch.Tensor | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass: (psi_v, psi_u, delta_last).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises.

    ``tab`` is the band's class table (``Tables.band_tab``) on the same
    device; without it the table is built from ``band`` on the host, which
    waits for the device.

    What the kernel takes: 1 <= n <= 512 states, at most ``MAX_FRAMES``
    frames, float32 scores of either sign that are finite or -inf (NaN and
    +inf are not scores).  Its results are the plain version's as long as
    the running delta stays within +-2^27, which log-probabilities no
    smaller than ``LOG_FLOOR`` do for every T it takes."""
    if log_obs_v.device.type == "cpu":
        return viterbi_fwd_plain(log_obs_v, log_obs_u,
                                 dense_from_band(band, n, w),
                                 log_stay, log_switch)
    dev = log_obs_v.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if log_obs_v.dim() != 3:
        raise ValueError(f"log_obs_v must be (B, T, n), got "
                         f"{tuple(log_obs_v.shape)}")
    B, T, _ = log_obs_v.shape
    if T < 1 or B < 1:
        raise ValueError(f"empty decode: B={B}, T={T}")
    if not 1 <= n <= 512:
        raise ValueError(f"the CUDA decode takes 1..512 states, got n={n}")
    if w < 0:
        raise ValueError(f"negative band half-width {w}")
    if T > MAX_FRAMES:
        raise ValueError(f"the CUDA decode takes at most {MAX_FRAMES} frames, "
                         f"got T={T}")
    _check("log_obs_v", log_obs_v, torch.float32, (B, T, n), dev)
    _check("log_obs_u", log_obs_u, torch.float32, (B, T), dev)
    _check("band", band, torch.float32, (n, 2 * w + 1), dev)
    if tab is None:
        tab = torch.from_numpy(band_class_table(band.cpu().numpy(), n, w)
                               ).to(dev)
    _check("tab", tab, torch.float32, (n if n < 2 * w + 1 else w + 1, w + 1),
           dev)
    props = torch.cuda.get_device_properties(dev)
    tile, cluster = pick_forward_variant(B, props.multi_processor_count)
    out = _launch_fwd(log_obs_v, log_obs_u, tab, n, w, log_stay, log_switch,
                      tile, cluster, max_shared_memory(dev))
    LAUNCHES["viterbi_fwd"] += 1
    LAST_BATCH["viterbi_fwd"] = B
    SEQUENCES["viterbi_fwd"] += B
    return out


def viterbi_back(delta_last: torch.Tensor, psi_v: torch.Tensor,
                 psi_u: torch.Tensor) -> torch.Tensor:
    """Backtrace: states (B, T) int32.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernels (two device kernels, one
    count) or raises."""
    if psi_v.device.type == "cpu":
        return viterbi_back_plain(delta_last, psi_v, psi_u)
    dev = psi_v.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if psi_v.dim() != 3:
        raise ValueError(f"psi_v must be (B, T, n), got {tuple(psi_v.shape)}")
    B, T, n = psi_v.shape
    if T < 1 or B < 1 or n < 1:
        raise ValueError(f"empty backtrace: B={B}, T={T}, n={n}")
    _check("delta_last", delta_last, torch.float32, (B, 2, n), dev)
    _check("psi_v", psi_v, torch.int32, (B, T, n), dev)
    _check("psi_u", psi_u, torch.int32, (B, T, n), dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    n_chunks = -(-(T - 1) // BACK_CHUNK)
    maps = torch.empty((B, max(n_chunks, 1), 2 * n), dtype=torch.int32,
                       device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.aegis_viterbi_back(
            delta_last.data_ptr(), psi_v.data_ptr(), psi_u.data_ptr(),
            maps.data_ptr(), states.data_ptr(), B, T, n, BACK_CHUNK,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "viterbi_back")
    LAUNCHES["viterbi_back"] += 1
    LAST_BATCH["viterbi_back"] = B
    SEQUENCES["viterbi_back"] += B
    return states


def viterbi_decode_cuda(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                        band: torch.Tensor, n: int, w: int, log_stay: float,
                        log_switch: float,
                        tab: torch.Tensor | None = None) -> torch.Tensor:
    """Banded Viterbi decode, forward pass then backtrace: states (B, T)
    int32 in [0, 2n), voiced iff < n.  Same semantics as the dense scan
    aegis_tpu/core/pyin.py::viterbi_decode, ties included."""
    psi_v, psi_u, delta_last = viterbi_fwd(log_obs_v, log_obs_u, band, n, w,
                                           log_stay, log_switch, tab)
    return viterbi_back(delta_last, psi_v, psi_u)
