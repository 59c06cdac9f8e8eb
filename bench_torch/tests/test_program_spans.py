"""CPU tests of the per-layer metrics that read the program's own spans
(``program_spans.py``): every cell, run traced at a test size, reports each
of its metrics read on the host's clock; those read against the device's
gaps need a device and are left out here.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 91


def _span_metrics(workload: str, source: str):
    """The cell's per-layer metrics whose reader is program_spans'."""
    return [m["name"] for m in run.cell_metrics(BENCH, "per_layer", workload)
            if m["source"] == source and "program_spans" in (
                run.HERE / "metrics" / f"{m['name']}.py").read_text()]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_reports_the_program_span_metrics(workload):
    wl = next(w for w in BENCH["workloads"] if w["name"] == workload)
    cfg = run.load_json(run.HERE / "configs" / f"{wl['config']}.json")
    mix = run.load_json(run.HERE / "traffic" / f"{wl['traffic']}.json")
    mix["takes"]["lengths_s"] = [40] if mix["load"] == "live" else [3, 5]
    mix["trace_items"] = 2
    run.set_cache_dirs()
    res = run.run_cell(BENCH, workload, SEED, 2.0, 1, "cpu", False, cfg, mix)
    assert res["correct"], res["checks"]
    host = _span_metrics(workload, "host_clock")
    assert host, workload
    for name in host:
        v = res["metrics"].get(name, {}).get("value")
        assert v is not None and v >= 0, (name, res["metrics"])
    # no device operation on the CPU: nothing to read, and left out
    for name in _span_metrics(workload, "device_trace"):
        assert name not in res["metrics"], name
    if workload == "v1_live_mono":
        assert res["metrics"]["tiles.live"]["value"] >= 1
    if "server_self_ms.request" in host:
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert m["server_self_ms.request"] <= m["serve_ms.request"]
        assert m["decode_ms.request"] <= m["server_self_ms.request"]
