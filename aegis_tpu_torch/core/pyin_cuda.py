"""The pYIN Viterbi decode as two CUDA kernels, with their plain versions.

Kernels (``aegis_tpu_torch/csrc/viterbi.cu``, CUDA C++ for sm_90a):

  * ``viterbi_fwd``  replaces ``_fwd_kernel``  of aegis_tpu/core/pyin_pallas.py
  * ``viterbi_back`` replaces ``_back_kernel`` of aegis_tpu/core/pyin_pallas.py

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor; there is no fallback between the two.  Each
kernel launch adds one to ``LAUNCHES[name]``, so a run can show that it
went through the kernels.

The library is compiled with nvcc at first use into ``build/aegis_tpu_torch/``
under the repository root, keyed by a hash of the source and the flags,
and loaded with ctypes.  Both the build and any import of a GPU toolchain
happen inside the calls, never at import time.

All tensors carry a leading batch dimension B (one CTA per sequence):
log_obs_v (B, T, n), log_obs_u (B, T), backpointers psi_v / psi_u
(B, T, n) int32 holding the absolute predecessor state in [0, 2n) with row
0 zero, delta_last (B, 2, n), states (B, T) int32.
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

from aegis_tpu_torch.core.tables import LOG_FLOOR

LAUNCHES = {"viterbi_fwd": 0, "viterbi_back": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "viterbi.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aegis_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def build() -> Path:
    """Compile the kernels' shared library if this source and these flags
    have not been built yet; return its path.  The compiler's report
    (registers, shared memory, spills) is kept beside it as ``.ptxas.txt``."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libaegis_viterbi_{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        so_path.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so_path)
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.aegis_viterbi_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                          f, f, f, f, p]
        lib.aegis_viterbi_fwd.restype = ctypes.c_int
        lib.aegis_viterbi_back.argtypes = [p, p, p, p, i, i, i, p]
        lib.aegis_viterbi_back.restype = ctypes.c_int
        _LIB = lib
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


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def viterbi_fwd(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                band: torch.Tensor, n: int, w: int, log_stay: float,
                log_switch: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass: (psi_v, psi_u, delta_last).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises."""
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
    _check("log_obs_v", log_obs_v, torch.float32, (B, T, n), dev)
    _check("log_obs_u", log_obs_u, torch.float32, (B, T), dev)
    _check("band", band, torch.float32, (n, 2 * w + 1), dev)
    psi_v = torch.empty((B, T, n), dtype=torch.int32, device=dev)
    psi_u = torch.empty((B, T, n), dtype=torch.int32, device=dev)
    delta_last = torch.empty((B, 2, n), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.aegis_viterbi_fwd(
            log_obs_v.data_ptr(), log_obs_u.data_ptr(), band.data_ptr(),
            psi_v.data_ptr(), psi_u.data_ptr(), delta_last.data_ptr(),
            B, T, n, w, float(np.log(1.0 / (2 * n))), float(LOG_FLOOR),
            log_stay, log_switch, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "viterbi_fwd")
    LAUNCHES["viterbi_fwd"] += 1
    return psi_v, psi_u, delta_last


def viterbi_back(delta_last: torch.Tensor, psi_v: torch.Tensor,
                 psi_u: torch.Tensor) -> torch.Tensor:
    """Backtrace: states (B, T) int32.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
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
    lib = library()
    with torch.cuda.device(dev):
        err = lib.aegis_viterbi_back(
            delta_last.data_ptr(), psi_v.data_ptr(), psi_u.data_ptr(),
            states.data_ptr(), B, T, n,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "viterbi_back")
    LAUNCHES["viterbi_back"] += 1
    return states


def viterbi_decode_cuda(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                        band: torch.Tensor, n: int, w: int, log_stay: float,
                        log_switch: float) -> torch.Tensor:
    """Banded Viterbi decode, forward pass then backtrace: states (B, T)
    int32 in [0, 2n), voiced iff < n.  Same semantics as the dense scan
    aegis_tpu/core/pyin.py::viterbi_decode, ties included."""
    psi_v, psi_u, delta_last = viterbi_fwd(log_obs_v, log_obs_u, band, n, w,
                                           log_stay, log_switch)
    return viterbi_back(delta_last, psi_v, psi_u)
