"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cell's GPUs.  The
cell's configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``) are found by name; the mix names its load
(``loads/<load>.py``), each end-to-end metric is ``e2e/<name>.py`` and
each per-layer metric ``metrics/<name>.py``.  A run sets up (the takes
from the seed, the program, one item of every shape the cell sends), then
with ``--trace 0`` measures the window for ``--seconds`` and reports the
cell's end-to-end metrics, or with ``--trace 1`` profiles a fixed slice of
items and reports its per-layer metrics.  Either way it then compares a
sample of what the window produced with the plain reference
(``checks/<check>.py``), once the program is freed, and prints every
number compared beside its limit, last on standard error and last in the
result line.  Without a CUDA device, or with fewer than the cell asks
for, it exits 1 and prints no result.

``--control`` runs the control of the check, which has to come out not
correct: the program with the lower-precision ingest the mix's
``control`` names switched on, or, where the path has no such option
(``"by": "reference"``), the reference computed on it in the program's
place.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
HERE = ROOT / "bench_torch"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    spec = importlib.util.spec_from_file_location(
        "bench_torch_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, kind: str, workload: str) -> List[Dict]:
    """The metrics of ``kind`` ("end_to_end" / "per_layer") the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    base = ROOT / "build" / "bench_torch"
    for var, sub in (("AEGIS_CACHE_DIR", "aegis_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def device_info(cuda: bool, chips: int) -> Dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, "power_limit": "none"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
            "power_limit": smi}


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: int, device: str = "cuda", control: bool = False,
             cfg: Optional[Dict] = None, mix: Optional[Dict] = None) -> Dict:
    """One run of a cell; returns the result line's object.  ``cfg`` and
    ``mix`` replace the cell's files (the CPU tests run tiny takes)."""
    import numpy as np
    import torch

    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = cfg or load_json(HERE / "configs" / f"{wl['config']}.json")
    mix = mix or load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    cuda = device == "cuda"
    # the control (the mix's "control"): the program's own lower-precision
    # path where it has one, else the reference computed in it, put in the
    # program's place
    ctl = mix["control"] if control else None
    by_reference = bool(ctl) and ctl["by"] == "reference"
    load_mod = importlib.import_module(f"bench_torch.loads.{mix['load']}")
    load = load_mod.Load(cfg, mix, seed, device, str(ROOT),
                         ctl["transport"] if ctl and not by_reference
                         else "none")
    try:
        load.setup()
        if cuda:
            torch.cuda.synchronize()
        run = {"setup_s": time.perf_counter() - _T_START}
        result: Dict = {"metrics": {}}
        if trace:
            from bench_torch import trace as trace_mod

            sl = trace_mod.run(load, int(mix["trace_items"]), cuda)
            items = sl.items
            for m in cell_metrics(bench, "per_layer", workload):
                v = load_file_module(HERE / "metrics" / f"{m['name']}.py").read(sl)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
            breakdown = trace_mod.breakdown(sl)
        else:
            items = load.window(seconds)
            run["items"] = items
            run["window_s"] = (max(it["t1"] for it in items)
                               - min(it["t0"] for it in items))
            for m in cell_metrics(bench, "end_to_end", workload):
                v = load_file_module(HERE / "e2e" / f"{m['name']}.py").value(run)
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev = device_info(cuda, wl["chips"])
        if trace:
            dev["busy_s"], dev["window_s"] = sl.busy_s, sl.window_s
        samples = load.samples(np.random.default_rng(
            [int(seed) % (1 << 64), 0x5EED]))
    finally:
        load.close()
    del load
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    check = importlib.import_module(f"bench_torch.checks.{mix['check']}")
    t_check = time.perf_counter()
    numbers = check.check(samples, cfg, mix, device,
                          **({"control": ctl["transport"]} if by_reference
                             else {}))
    print(f"check_seconds {time.perf_counter() - t_check!r}", file=sys.stderr)
    limits = cfg["check"]["limits"][mix["check"]]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    attempted = len(items)
    failed = sum(not it["ok"] for it in items)
    correct = (failed == 0 and bool(samples) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result["metrics"], "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch

    cuda = torch.cuda.is_available()
    if not cuda or torch.cuda.device_count() < wl[0]["chips"]:
        print(f"bench_torch needs {wl[0]['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {cuda}, device_count() "
              f"{torch.cuda.device_count() if cuda else 0}", file=sys.stderr)
        return 1
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      args.trace, "cuda", args.control)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
