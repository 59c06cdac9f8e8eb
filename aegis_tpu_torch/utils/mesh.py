"""The process mesh: the port's stand-in for ``jax.sharding.Mesh``.

The JAX package runs its multi-device paths as one program over a (data,
time) mesh of devices (``shard_map`` with ``ppermute``, ``pmax``, ``psum``
and ``all_gather``).  The port runs them as one process a rank over
``torch.distributed``: rank r sits at ``(r // time, r % time)`` of a (data,
time) grid, holds its device (``cuda:(r % device_count)`` on the card),
one subgroup for its time row and one for the whole world.  Every rank
runs the same code on its own block and ends with the whole answer, as
every caller of a JAX program does.

The collectives use two primitives only, ``all_gather`` and a MAX
``all_reduce``, so every result is independent of the backend:

  * ``pmax_time``      a MAX all-reduce over the time row (order-free);
  * ``psum_time`` / ``psum_world``  all-gather the partial sums and add them
    in rank order: a sum all-reduce promises no order, and the ROADMAP's
    "Deterministic sums" rule binds every collective;
  * ``all_gather_time`` the tiled all-gather of the trend rows;
  * ``halo``           the ``ppermute`` halo exchange: each rank's head and
    tail are all-gathered over the time row and each rank takes its
    neighbours' (no point-to-point sends, which gloo does not take on CUDA
    tensors);
  * ``gather_world``   every rank's block, in rank order.

NCCL needs one card a rank and raises otherwise.  ``backend="gloo"`` on CUDA
lets ranks share a card: every collective then copies its tensor to the
host and back (``staging == "host"``), every time.

``run_spmd`` spawns the ranks of a (data, time) grid on a ``FileStore`` in
a temporary directory, runs one function of the port on each with
``mesh=`` and checks that every rank returned the same result.
"""

from __future__ import annotations

import datetime
import inspect
import math
import os
import pickle
import tempfile
import time
import traceback
from time import sleep
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aegis_tpu_torch import resolve_device

# how long a rank waits in a collective for the others
TIMEOUT_S = 600


class Mesh:
    """A (data, time) grid over the initialized process group."""

    def __init__(self, data: int, time: int, device="cuda",
                 backend: Optional[str] = None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized torch.distributed "
                               "process group")
        world, rank = dist.get_world_size(), dist.get_rank()
        if data < 1 or time < 1 or world != data * time:
            raise ValueError(f"a ({data}, {time}) mesh needs {data * time} "
                             f"ranks; the world has {world}")
        dev = resolve_device(device)
        if dev.type == "cuda":
            backend = backend or "nccl"
            n_cards = torch.cuda.device_count()
            if backend == "nccl" and world > n_cards:
                raise RuntimeError(
                    f"NCCL needs one card a rank: {world} ranks, {n_cards} "
                    "card(s); ranks that share a card take backend='gloo'")
            dev = torch.device("cuda", rank % n_cards)
            torch.cuda.set_device(dev)
        else:
            backend = backend or "gloo"
            if backend != "gloo":
                raise ValueError(f"backend {backend!r} on the CPU: the CPU "
                                 "takes gloo")
        self.data, self.time = data, time
        self.world, self.rank = world, rank
        self.data_index, self.time_index = divmod(rank, time)
        self.device, self.backend = dev, backend
        self.staging = ("host" if backend == "gloo" and dev.type == "cuda"
                        else "none")
        # every rank creates every group, in the same order
        self.world_group = dist.new_group(list(range(world)), backend=backend)
        rows = [dist.new_group([d * time + j for j in range(time)],
                               backend=backend) for d in range(data)]
        self.time_group = rows[self.data_index]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "time": self.time}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, time={self.time}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    # ----------------------------------------------------------- collectives

    def _send(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.staging == "host" else x

    def _recv(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staging == "host" else x

    def _gather(self, x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
        x = self._send(x)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return [self._recv(p) for p in parts]

    def pmax_time(self, x: torch.Tensor) -> torch.Tensor:
        y = self._send(x).clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.time_group)
        return self._recv(y)

    def psum_time(self, x: torch.Tensor) -> torch.Tensor:
        return _ordered_sum(self._gather(x, self.time_group, self.time))

    def psum_world(self, x: torch.Tensor) -> torch.Tensor:
        return _ordered_sum(self.gather_world(x))

    def all_gather_time(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._gather(x, self.time_group, self.time), dim=dim)

    def gather_world(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self._gather(x, self.world_group, self.world)

    def halo(self, head: torch.Tensor, tail: torch.Tensor
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(left, right): the tail of the previous rank on the time row and
        the head of the next one, each (b, ctx); None at the row's ends,
        where the caller splices its track-edge convention."""
        ctx = head.shape[1]
        parts = self._gather(torch.cat([head, tail], dim=1), self.time_group,
                             self.time)
        t = self.time_index
        left = parts[t - 1][:, ctx:] if t > 0 else None
        right = parts[t + 1][:, :ctx] if t < self.time - 1 else None
        return left, right


class _Solo:
    """The mesh of the one-process programs: one rank, no collective."""

    data = time = world = 1
    rank = data_index = time_index = 0

    @staticmethod
    def pmax_time(x):
        return x

    psum_time = psum_world = pmax_time

    @staticmethod
    def all_gather_time(x, dim):
        return x

    @staticmethod
    def gather_world(x):
        return [x]

    @staticmethod
    def halo(head, tail):
        return None, None


SOLO = _Solo()


def _ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# the meshes made for calls that name none, kept for the world they were
# made in: every rank makes the same ones in the same order, so each
# (shape, device, backend) builds its process groups once a world
_DEFAULT_MESHES: Dict[tuple, Mesh] = {}
_DEFAULT_WORLD: List[Any] = [None]


def _world_mesh(data: int, time: int, device, backend: Optional[str]) -> Mesh:
    if _DEFAULT_WORLD[0] is not dist.group.WORLD:
        _DEFAULT_MESHES.clear()
        _DEFAULT_WORLD[0] = dist.group.WORLD
    backend = backend or dist.get_backend()
    key = (data, time, str(resolve_device(device)), backend)
    if key not in _DEFAULT_MESHES:
        _DEFAULT_MESHES[key] = Mesh(data, time, device, backend)
    return _DEFAULT_MESHES[key]


def default_mesh(time_only: bool = True, device="cuda",
                 backend: Optional[str] = None) -> Mesh:
    """Every rank of the world on the time axis (``time_only``) or on the
    data axis; the counterpart of the JAX package's ``_default_mesh``.
    ``backend`` defaults to the world's; one mesh a shape, device and
    backend in a world."""
    world = dist.get_world_size()
    return (_world_mesh(1, world, device, backend) if time_only
            else _world_mesh(world, 1, device, backend))


def rank_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device a call runs on: ``device`` without a mesh, else the mesh's,
    which a ``device`` of another type or index may not contradict."""
    if mesh is None:
        return resolve_device(device)
    want = torch.device(device)
    if want.type != mesh.device.type or (want.index is not None
                                         and want.index != mesh.device.index):
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"{mesh.device}")
    return mesh.device


def resolve_mesh(mesh: Optional[Mesh], device, batch: Optional[int] = None,
                 time_only: bool = True):
    """(mesh or None, device) of a call.  No mesh and no process group: the
    one-process program.  No mesh in an initialized world: the JAX
    package's default over all ranks, ``(gcd(world, batch), ...)`` for a
    batch of ``batch`` tracks, else ``default_mesh(time_only)``."""
    if mesh is None and not dist.is_initialized():
        return None, resolve_device(device)
    if mesh is None:
        if batch is not None:
            world = dist.get_world_size()
            b_axis = math.gcd(world, batch)
            mesh = _world_mesh(b_axis, world // b_axis, device, None)
        else:
            mesh = default_mesh(time_only, device)
    return mesh, rank_device(mesh, device)


# --------------------------------------------------------------------------
# Spawning the ranks
# --------------------------------------------------------------------------

# what the rank's run_calls measured, one record a call (read by _rank_main)
CALLS: List[dict] = []


def _counts() -> Tuple[dict, dict]:
    from aegis_tpu_torch.core import pyin_cuda

    return (dict(pyin_cuda.LAUNCHES),
            {k: dict(v) for k, v in pyin_cuda.SHAPES.items()})


def _diff(before: Tuple[dict, dict]) -> Tuple[dict, dict]:
    launches, shapes = _counts()
    return ({k: v - before[0].get(k, 0) for k, v in launches.items()},
            {k: {s: c - before[1][k].get(s, 0) for s, c in v.items()
                 if c != before[1][k].get(s, 0)} for k, v in shapes.items()})


def _with_device(fn: Callable, kwargs: dict, device: torch.device) -> dict:
    if "device" in inspect.signature(fn).parameters and "device" not in kwargs:
        return {**kwargs, "device": str(device)}
    return kwargs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def call(fn: Callable, *args, mesh_shape: Optional[Tuple[int, int]] = None,
         reps: int = 1, **kwargs) -> dict:
    """One entry of ``run_calls``: ``fn(*args, mesh=..., **kwargs)`` on a
    (data, time) mesh of ``mesh_shape`` (default: the rank's own mesh),
    ``reps`` times."""
    return {"fn": fn, "args": args, "kwargs": kwargs,
            "mesh_shape": mesh_shape, "reps": reps}


def run_calls(calls: List[dict], mesh: Mesh) -> list:
    """Run each ``call`` in order on every rank of the world and return
    their results (of the first repetition).  A call whose ``mesh_shape``
    is not the rank's mesh runs on a new mesh of that shape over the same
    world.  Each call's wall ms a repetition (CUDA events on the card),
    launches and launch shapes (of the first) go to ``CALLS``."""
    results = []
    for c in calls:
        shape = c["mesh_shape"]
        m = (mesh if shape is None or tuple(shape) == (mesh.data, mesh.time)
             else Mesh(*shape, device=mesh.device, backend=mesh.backend))
        kwargs = _with_device(c["fn"], c["kwargs"], m.device)
        ms, first = [], None
        for i in range(c["reps"]):
            before = _counts()
            _sync(m.device)
            if m.device.type == "cuda":
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = c["fn"](*c["args"], mesh=m, **kwargs)
                t1.record()
                _sync(m.device)
                ms.append(t0.elapsed_time(t1))
            else:
                t0 = time.perf_counter()
                out = c["fn"](*c["args"], mesh=m, **kwargs)
                ms.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                first = (out, _diff(before))
        results.append(first[0])
        CALLS.append({"name": getattr(c["fn"], "__qualname__", str(c["fn"])),
                      "mesh": m.shape, "ms": ms, "launches": first[1][0],
                      "shapes": first[1][1]})
    return results


def _rank_main(rank: int, world: int, data: int, time_: int, tmp: str,
               device: str, backend: Optional[str]) -> None:
    """One rank of ``spmd``: join the group, build the mesh, run the call,
    write its record (or its traceback) into ``tmp``."""
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = Mesh(data, time_, device=device, backend=backend)
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args, kwargs = pickle.load(f)
        kwargs = _with_device(fn, kwargs, mesh.device)
        CALLS.clear()
        before = _counts()
        t0 = time.perf_counter()
        result = fn(*args, mesh=mesh, **kwargs)
        _sync(mesh.device)
        seconds = time.perf_counter() - t0
        launches, shapes = _diff(before)
        record = {"rank": rank, "device": str(mesh.device),
                  "backend": mesh.backend, "staging": mesh.staging,
                  "mesh": mesh.shape, "seconds": seconds,
                  "launches": launches, "shapes": shapes,
                  "calls": list(CALLS), "result": result}
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(record, f)
        os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spmd(fn: Callable, data: int, time: int, *args, device="cuda",
         backend: Optional[str] = None, **kwargs) -> List[dict]:
    """Spawn the data * time ranks of a (data, time) mesh, run
    ``fn(*args, mesh=mesh, **kwargs)`` on each (``device=`` the rank's own
    device when ``fn`` takes one and the caller names none) and return
    each rank's record in rank order: its ``result``, ``device``,
    ``backend``, ``staging``, ``seconds``, the Viterbi kernels'
    ``launches`` and ``shapes`` in its run, and its ``calls`` (run_calls).
    A rank that raises makes this raise, naming the rank; the others are
    stopped."""
    import multiprocessing as mp

    world = data * time
    dev = resolve_device(device)
    if dev.type == "cuda" and (backend or "nccl") == "nccl" \
            and world > torch.cuda.device_count():
        raise RuntimeError(f"NCCL needs one card a rank: {world} ranks, "
                           f"{torch.cuda.device_count()} card(s)")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="aegis_spmd_") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args, kwargs), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, data, time, tmp, str(device),
                                   backend), daemon=True)
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            while True:
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = os.path.join(tmp, f"rank{r}.err")
                    why = (open(err).read() if os.path.exists(err)
                           else f"exit code {procs[r].exitcode}")
                    raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
                if all(p.exitcode == 0 for p in procs):
                    break
                sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        records = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                records.append(pickle.load(f))
    return records


def run_spmd(fn: Callable, data: int, time: int, *args, device="cuda",
             backend: Optional[str] = None, **kwargs):
    """``spmd``, then the one result every rank returned: raises when two
    ranks disagree (the JAX single-controller contract: every caller gets
    the whole answer)."""
    records = spmd(fn, data, time, *args, device=device, backend=backend,
                   **kwargs)
    first = records[0]["result"]
    for rec in records[1:]:
        if not results_equal(first, rec["result"]):
            raise AssertionError(f"rank {rec['rank']} returned another "
                                 "result than rank 0")
    return first


def results_equal(a: Any, b: Any) -> bool:
    """Exact equality of two results: dicts, sequences, arrays and tensors
    (NaN equal to NaN), modules by their parameters, else ``==``."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(results_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(results_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.nn.Module):
        return isinstance(b, torch.nn.Module) and results_equal(
            {k: v.cpu() for k, v in a.state_dict().items()},
            {k: v.cpu() for k, v in b.state_dict().items()})
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and bool(np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    return a == b
