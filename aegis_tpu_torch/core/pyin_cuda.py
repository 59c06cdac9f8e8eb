"""The pYIN Viterbi decode as two CUDA kernels, with their plain versions,
and the trough probabilities with their scatter into pitch bins as one.

Kernels (CUDA C++ for sm_90a):

  * ``viterbi_fwd``  replaces ``_fwd_kernel``  of aegis_tpu/core/pyin_pallas.py
  * ``viterbi_back`` replaces ``_back_kernel`` of aegis_tpu/core/pyin_pallas.py
    (both ``aegis_tpu_torch/csrc/viterbi.cu``)
  * ``trough_obs`` replaces no TPU kernel: core/pyin.py's threshold loop
    and per-lag scatter as one launch (``aegis_tpu_torch/csrc/trough_obs.cu``)

Each Viterbi wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; there is no fallback between the two.
``trough_obs`` takes CUDA tensors only: its plain version is the two loops of
core/pyin.py, which ``core/pyin.py::trough_observations`` runs on a CPU
tensor.  Each kernel launch adds one to ``LAUNCHES[name]``, records its
batch size B in ``LAST_BATCH[name]``, adds B to ``SEQUENCES[name]`` and adds
one to ``SHAPES[name][shape]``, so a run can show that it went through the
kernels, with how many sequences and at which shapes.  The counts
and the build are shared by every thread of a process (the REST server runs
requests in threads), so each is updated under a lock.  Launches a thread
makes inside ``recording_launches()`` (a CUDA graph's warm-up and capture)
are recorded there and not counted; ``count_launches`` counts a recorded
list once, for each replay of the graph.  ``recording_decodes()`` keeps the
span attributes of the decodes a graph captures, for its replays' spans.

Each source is compiled with nvcc at first use into ``build/aegis_tpu_torch/``
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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np
import torch

from aegis_tpu_torch.core.tables import LOG_FLOOR, band_class_table
from aegis_tpu_torch.utils.prof import phase, recording

LAUNCHES = {"viterbi_fwd": 0, "viterbi_back": 0, "trough_obs": 0}
LAST_BATCH = {"viterbi_fwd": 0, "viterbi_back": 0, "trough_obs": 0}
# the sequences launched in all (the sum of B over the launches): equal to
# LAUNCHES where every launch had B = 1, as on the live path
SEQUENCES = {"viterbi_fwd": 0, "viterbi_back": 0, "trough_obs": 0}
# launches by shape: (B, T, n, w) for the forward kernel, (B, T, n) for the
# backtrace, (B, T, L, n) for the trough kernel (B T rows of L lags)
SHAPES = {"viterbi_fwd": {}, "viterbi_back": {}, "trough_obs": {}}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "viterbi.cu"
TROUGH_SOURCE = SOURCE.with_name("trough_obs.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aegis_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the forward kernel's destination tiles the library is built with
# (csrc/viterbi.cu): 88 is 8 destinations a thread and 8 lanes a tile, 96
# the same with 16 lanes, two a destination (clusters only)
FWD_TILES = (88, 96)
# the CTAs (one thread-block cluster) that share one sequence's forward pass
FWD_CLUSTERS = (1, 2, 4, 8)
# lanes a destination tile of each FWD_TILES entry (S in csrc/viterbi.cu);
# every tile has D = 8 destinations
_TILE_LANES = {88: 8, 96: 16}
_TILE_D = 8
# the most threads a CTA of the forward kernel is launched with, and the
# warps of a cluster the one-pass kernel's block maximum takes
FWD_MAX_THREADS = 512
FWD_ONE_PASS_WARPS = 32
# shared memory one block may ask for on an H100 (227 KB); the wrapper
# reads the card's own figure (max_shared_memory)
H100_MAX_SHARED_MEMORY = 227 * 1024


@dataclass(frozen=True)
class ForwardLaunch:
    """How csrc/viterbi.cu::launch_fwd launches one variant of the forward
    pass: ``wide`` is viterbi_fwd_wide_kernel (the CTA's tiles in
    ``passes`` passes of its threads), else viterbi_fwd_kernel (one tile a
    thread); ``threads`` a CTA, ``warps`` across the cluster,
    ``smem_bytes`` of dynamic shared memory a CTA, ``table_in_smem``
    whether the expanded score table is among them."""
    tile: int
    cluster: int
    wide: bool
    threads: int
    passes: int
    warps: int
    smem_bytes: int
    table_in_smem: bool

    @property
    def kernel(self) -> str:
        """The forward kernel this launch runs, by its name in
        csrc/viterbi.cu."""
        return "viterbi_fwd_wide_kernel" if self.wide else "viterbi_fwd_kernel"


def forward_launch(n: int, w: int, tile: int, cluster: int,
                   max_smem: int) -> ForwardLaunch:
    """The launcher's arithmetic for n states, band half-width w, one
    (tile, cluster) variant and ``max_smem`` bytes of shared memory a block;
    raises ValueError naming the limit when the variant cannot launch.
    csrc/viterbi.cu::launch_fwd computes the same."""
    if tile not in FWD_TILES or cluster not in FWD_CLUSTERS:
        raise ValueError(f"tile {tile} / cluster {cluster}: not one of "
                         f"{FWD_TILES} / {FWD_CLUSTERS}")
    if n < 1 or w < 0:
        raise ValueError(f"the CUDA decode takes n >= 1 states and a band "
                         f"half-width w >= 0, got n={n}, w={w}")
    d, lanes_a_tile = _TILE_D, _TILE_LANES[tile]
    tiles_per_cta = -(-(-(-n // d)) // cluster)
    lanes = tiles_per_cta * lanes_a_tile
    threads = -(-lanes // 32) * 32
    wide = (threads > FWD_MAX_THREADS
            or cluster * (threads // 32) > FWD_ONE_PASS_WARPS)
    passes = 1
    if wide:
        passes = -(-lanes // FWD_MAX_THREADS)
        threads = -(-(-(-lanes // passes)) // 32) * 32
    warps = cluster * (threads // 32)
    warp_slots = warps if wide else FWD_ONE_PASS_WARPS
    # csrc/viterbi.cu: groups_per_lane, tile_span, row_stride, delta_stride
    span = 4 * lanes_a_tile * (-(-(2 * w + d) // (4 * lanes_a_tile)))
    np_ = (n + max(span, 2 * w) + d + 3) // 4 * 4
    fixed = 4 * (2 * 2 * np_ + 2 * 2 * warp_slots) + 4 * (np_ + 2 * 2 * warp_slots)
    n_cls = n if n < 2 * w + 1 else w + 1
    row = (span + d - 1 + 3) // 4 * 4
    table = (n_cls * row + 3) // 4 * 4 * 4
    if fixed > max_smem:
        raise ValueError(
            f"the CUDA decode at n={n}, w={w} (tile {tile}, cluster "
            f"{cluster}) needs {fixed} bytes of shared memory for its delta "
            f"buffers, over the {max_smem} a block may take")
    in_smem = fixed + table <= max_smem
    return ForwardLaunch(tile, cluster, wide, threads, passes, warps,
                         fixed + (table if in_smem else 0), in_smem)


def pick_forward_variant(B: int, n_sms: int, n: int, w: int,
                         max_smem: int) -> ForwardLaunch:
    """The launch of B sequences of n states on a card of n_sms SMs, as
    measured on the H100 (tools/bench_viterbi.py; PERF.md): a few
    sequences spread over clusters of 8 CTAs with two lanes a destination
    (tile 96); more sequences take clusters of 4, then 2, then one CTA
    each (tile 88), so that all clusters stay resident at once.  The
    (tile, cluster) does not depend on n: every variant launches wherever
    the delta buffers fit ``max_smem`` (``forward_launch`` raises where
    they do not)."""
    if 16 * B <= n_sms:
        tile, cluster = 96, 8
    else:
        tile, cluster = next(((88, c) for c in (4, 2) if c * B <= n_sms),
                             (88, 1))
    return forward_launch(n, w, tile, cluster, max_smem)


def max_shared_memory(dev: torch.device) -> int:
    """The bytes of shared memory one block may ask for on this card."""
    return getattr(torch.cuda.get_device_properties(dev),
                   "shared_memory_per_block_optin", H100_MAX_SHARED_MEMORY)


# frames a chunk of the backtrace
BACK_CHUNK = 64
# most frames one decode takes: with log-probabilities no smaller than
# LOG_FLOOR it keeps |delta| below 2^27, where the forward kernel's
# out-of-band rule is exact (csrc/viterbi.cu); about 3.4 hours of audio at
# 44 100 Hz, hop 512, in one fused call
MAX_FRAMES = 1 << 20

# rows a CTA of trough_obs_kernel takes, one warp each (csrc/trough_obs.cu)
TROUGH_WARPS = 4

_LIB = None
_TROUGH_LIB = None
# one build and one binding a process, whichever thread comes first; the
# others wait for it and get the same library
_BUILD_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# the list a thread records its launches into instead of counting them
_RECORD = threading.local()


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
    with _BUILD_LOCK:
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # unique per process and per thread: two processes sharing the
            # build directory never write into one temporary file
            tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}"
                                    f".{threading.get_ident()}")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, str(source), "-o",
                                   str(tmp)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            so_path.with_suffix(".ptxas.txt").write_text(proc.stdout
                                                         + proc.stderr)
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
    """The loaded kernel library (built on first use, once a process)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                _LIB = _bind(build())
    return _LIB


def trough_library() -> ctypes.CDLL:
    """The loaded trough kernel's library (built on first use, once a
    process)."""
    global _TROUGH_LIB
    if _TROUGH_LIB is None:
        with _LIB_LOCK:
            if _TROUGH_LIB is None:
                lib = ctypes.CDLL(str(build(TROUGH_SOURCE)))
                p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.aegis_trough_obs.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                 i, f, f, f, i, p]
                lib.aegis_trough_obs.restype = ctypes.c_int
                _TROUGH_LIB = lib
    return _TROUGH_LIB


def _count(name: str, shape: tuple) -> None:
    """One launch of kernel ``name`` at ``shape``, batch size first."""
    recorded = getattr(_RECORD, "launches", None)
    if recorded is not None:
        recorded.append((name, shape))
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        LAST_BATCH[name] = shape[0]
        SEQUENCES[name] += shape[0]
        SHAPES[name][shape] = SHAPES[name].get(shape, 0) + 1


@contextlib.contextmanager
def recording_launches() -> Iterator[List[Tuple[str, tuple]]]:
    """The launches this thread makes inside, as (name, shape) pairs in
    their order, instead of counting them: what a CUDA graph captured
    launches nothing until it is replayed."""
    outer = getattr(_RECORD, "launches", None)
    _RECORD.launches = recorded = []
    try:
        yield recorded
    finally:
        _RECORD.launches = outer


def count_launches(launched: List[Tuple[str, tuple]]) -> None:
    """Count launches recorded by ``recording_launches``: one replay."""
    for name, shape in launched:
        _count(name, shape)


@contextlib.contextmanager
def recording_decodes() -> Iterator[List[dict]]:
    """The ``decode_attrs`` of the decodes this thread captures into a CUDA
    graph inside, in their order: a replay runs no Python, so the graph
    makes each replay's ``aegis.viterbi`` spans from these."""
    outer = getattr(_RECORD, "decodes", None)
    _RECORD.decodes = recorded = []
    try:
        yield recorded
    finally:
        _RECORD.decodes = outer


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
                log_switch: float, tab: torch.Tensor | None = None,
                launch: ForwardLaunch | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass: (psi_v, psi_u, delta_last).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises.

    ``tab`` is the band's class table (``Tables.band_tab``) on the same
    device; without it the table is built from ``band`` on the host, which
    waits for the device.  ``launch`` is the variant to launch, where the
    caller has picked it already (``forward_launch_for``).

    What the kernel takes: any n >= 1 states and band half-width w >= 0
    whose double-buffered delta fits the card's shared memory
    (``forward_launch``; n up to about 10 400 at w = 501 and 11 300 at
    w = 51 on an H100, every pitch grid of ``PyinConfig.resolution`` down
    to 0.02 semitone), at most
    ``MAX_FRAMES`` frames, float32 scores of either sign that are finite or
    -inf (NaN and +inf are not scores).  Its results are the plain
    version's as long as the running delta stays within +-2^27, which
    log-probabilities no smaller than ``LOG_FLOOR`` do for every T it
    takes."""
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
    if T > MAX_FRAMES:
        raise ValueError(
            f"the CUDA decode takes at most {MAX_FRAMES} frames (about 3.4 h "
            f"at 44 100 Hz, hop 512), got T={T}: past that the out-of-band "
            "rule is no longer exact; decode long tracks in slabs "
            "(AegisEngine turbo_mode=\"stream\")")
    if launch is None:
        launch = forward_launch_for(log_obs_v, n, w)
    _check("log_obs_v", log_obs_v, torch.float32, (B, T, n), dev)
    _check("log_obs_u", log_obs_u, torch.float32, (B, T), dev)
    _check("band", band, torch.float32, (n, 2 * w + 1), dev)
    if tab is None:
        tab = torch.from_numpy(band_class_table(band.cpu().numpy(), n, w)
                               ).to(dev)
    _check("tab", tab, torch.float32, (n if n < 2 * w + 1 else w + 1, w + 1),
           dev)
    out = _launch_fwd(log_obs_v, log_obs_u, tab, n, w, log_stay, log_switch,
                      launch.tile, launch.cluster, max_shared_memory(dev))
    _count("viterbi_fwd", (B, T, n, w))
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
    _count("viterbi_back", (B, T, n))
    return states


def forward_launch_for(log_obs_v: torch.Tensor, n: int,
                       w: int) -> ForwardLaunch:
    """The forward launch for the B sequences of ``log_obs_v`` (a CUDA
    tensor) on its card: ``pick_forward_variant`` at the card's SMs and
    shared memory."""
    dev = log_obs_v.device
    return pick_forward_variant(
        log_obs_v.shape[0],
        torch.cuda.get_device_properties(dev).multi_processor_count, n, w,
        max_shared_memory(dev))


def viterbi_decode_cuda(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor,
                        band: torch.Tensor, n: int, w: int, log_stay: float,
                        log_switch: float,
                        tab: torch.Tensor | None = None) -> torch.Tensor:
    """Banded Viterbi decode, forward pass then backtrace: states (B, T)
    int32 in [0, 2n), voiced iff < n.  Same semantics as the dense scan
    aegis_tpu/core/pyin.py::viterbi_decode, ties included.

    While a profiler runs, the launches sit in one ``aegis.viterbi`` span
    (``decode_attrs``) that names the forward launch the pass makes,
    except inside a CUDA graph capture, whose replays run no Python: there
    the attributes go to ``recording_decodes``, where one is open."""
    launch, span = None, contextlib.nullcontext()
    capturing = (log_obs_v.is_cuda
                 and torch.cuda.is_current_stream_capturing())
    decodes = getattr(_RECORD, "decodes", None) if capturing else None
    if decodes is not None or (recording() and not capturing):
        if log_obs_v.is_cuda:
            launch = forward_launch_for(log_obs_v, n, w)
        attrs = decode_attrs(log_obs_v, n, w, launch)
        if decodes is not None:
            decodes.append(attrs)
        else:
            span = phase("aegis.viterbi", **attrs)
    with span:
        psi_v, psi_u, delta_last = viterbi_fwd(log_obs_v, log_obs_u, band, n,
                                               w, log_stay, log_switch, tab,
                                               launch)
        return viterbi_back(delta_last, psi_v, psi_u)


def decode_attrs(log_obs_v: torch.Tensor, n: int, w: int,
                 launch: ForwardLaunch | None) -> dict:
    """What a decode's ``aegis.viterbi`` span records: B, T, n, w and the
    forward kernel of ``launch`` with its tile, cluster and passes;
    ``"plain"`` (and no launch numbers) without a launch, on the CPU."""
    B, T = log_obs_v.shape[:2]
    if launch is None:
        return {"B": B, "T": T, "n": n, "w": w, "kernel": "plain",
                "tile": None, "cluster": None, "passes": None}
    return {"B": B, "T": T, "n": n, "w": w, "kernel": launch.kernel,
            "tile": launch.tile, "cluster": launch.cluster,
            "passes": launch.passes}


# --------------------------------------------------------------------------
# The trough kernel
# --------------------------------------------------------------------------

def trough_obs_launch(R: int, L: int, n: int, K: int,
                      max_smem: int) -> Tuple[int, int]:
    """(CTAs, bytes of dynamic shared memory a CTA) with which
    csrc/trough_obs.cu launches trough_obs_kernel on R rows of L lags into
    n bins with K thresholds: a warp a row, ``TROUGH_WARPS`` rows a CTA; the
    CTA holds the thresholds and their priors (K each) and the Boltzmann
    numerators and denominators (L each), and each warp three arrays of L
    and two of K.  Raises ValueError naming the limit where the kernel
    cannot launch."""
    if min(R, L, n, K) < 1:
        raise ValueError(f"the trough kernel takes R, L, n, K >= 1, got "
                         f"R={R}, L={L}, n={n}, K={K}")
    if R > 2 ** 31 - 1:
        raise ValueError(f"the trough kernel takes at most 2**31 - 1 rows, "
                         f"got R={R}")
    smem = 4 * (2 * (K + L) + TROUGH_WARPS * (3 * L + 2 * K))
    if smem > max_smem:
        raise ValueError(
            f"the trough kernel at L={L} lags and K={K} thresholds needs "
            f"{smem} bytes of shared memory a block, over the {max_smem} a "
            "block may take")
    return -(-R // TROUGH_WARPS), smem


def trough_obs(yin: torch.Tensor, mask: torch.Tensor, bins: torch.Tensor,
               thresholds: torch.Tensor, beta_probs: torch.Tensor, n: int,
               lam: float, no_trough_prob: float) -> torch.Tensor:
    """The observation plane obs (..., n) of the CMNDF rows yin (..., L)
    float32 (rows at one stride, lags at unit stride: a slice of a wider
    plane is read in place), their trough mask (bool) and the pitch bin of
    every lag (int64), with the (K,) float32 ``thresholds`` and
    ``beta_probs``: one launch of trough_obs_kernel, bitwise core/pyin.py's
    ``trough_probabilities`` then ``scatter_bins`` on the card.  CUDA
    tensors only; counted at (B, T, L, n), B the product of the leading
    dimensions before the last two (1 for rows (T, L))."""
    dev = yin.device
    if dev.type != "cuda":
        raise ValueError(f"trough_obs launches a CUDA kernel, got a tensor "
                         f"on {dev} (core/pyin.py::trough_observations runs "
                         "the plain loops there)")
    if yin.dim() < 2:
        raise ValueError(f"yin must be (..., T, L), got {tuple(yin.shape)}")
    shape = tuple(yin.shape)
    *lead, T, L = shape
    B = int(np.prod(lead)) if lead else 1
    K = thresholds.shape[0] if thresholds.dim() == 1 else -1
    if yin.dtype != torch.float32 or yin.stride(-1) != 1:
        raise ValueError(f"yin must be float32 at unit stride along the lags, "
                         f"got {yin.dtype}, strides {yin.stride()}")
    try:
        ld = yin.view(-1, L).stride(0)
    except RuntimeError:
        raise ValueError(f"yin's rows must lie at one stride, got strides "
                         f"{yin.stride()} for shape {shape}") from None
    _check("mask", mask, torch.bool, shape, dev)
    _check("bins", bins, torch.int64, shape, dev)
    _check("thresholds", thresholds, torch.float32, (K,), dev)
    _check("beta_probs", beta_probs, torch.float32, (K,), dev)
    max_smem = max_shared_memory(dev)
    trough_obs_launch(B * T, L, n, K, max_smem)
    obs = torch.empty(shape[:-1] + (n,), dtype=torch.float32, device=dev)
    lib = trough_library()
    with torch.cuda.device(dev):
        err = lib.aegis_trough_obs(
            yin.data_ptr(), mask.data_ptr(), bins.data_ptr(),
            thresholds.data_ptr(), beta_probs.data_ptr(), obs.data_ptr(),
            B * T, L, ld, n, K, -lam, float(-np.expm1(-lam)), no_trough_prob,
            max_smem, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "trough_obs")
    _count("trough_obs", (B, T, L, n))
    return obs
