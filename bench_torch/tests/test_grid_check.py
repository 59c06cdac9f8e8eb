"""CPU tests of ``checks/v1_grid.py``, the check of the 5-cent grid's cell:
a frame's bin read back from its f0 row, and a program on the coarser
grid (the same file at resolution 0.1, n = 450) coming out not correct
through the harness, where every number of the v1 check alone passes.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import program, run  # noqa: E402
from bench_torch.checks import v1_grid  # noqa: E402
from bench_torch.reference import v1_device  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 77


def test_a_bin_is_read_back_from_its_f0():
    p = run.load_json(run.HERE / "configs" / "v1_fine_44k.json")["pyin"]
    hz = v1_device.bin_hz(p["fmin"], 900, 20)
    f0 = np.concatenate([hz, [0.0, np.nan, hz[3]]])
    voiced = np.concatenate([np.ones(900, bool), [False, False, False]])
    got = v1_grid.bins(f0, voiced, p["fmin"], 20)
    assert np.array_equal(got[:900], np.arange(900))
    assert np.array_equal(got[900:], [-1, -1, -1])
    # the n = 450 grid's bins are the even ones of the 900
    coarse = v1_device.bin_hz(p["fmin"], 450, 10)
    assert np.array_equal(v1_grid.bins(coarse, np.ones(450, bool),
                                       p["fmin"], 20), 2 * np.arange(450))


def test_a_coarse_grid_program_is_not_correct(monkeypatch):
    wl = next(w for w in BENCH["workloads"] if w["name"] == "v1_fine_rest")
    cfg = run.load_json(run.HERE / "configs" / f"{wl['config']}.json")
    mix = run.load_json(run.HERE / "traffic" / f"{wl['traffic']}.json")
    mix["takes"]["lengths_s"] = [3, 5]
    mix["trace_items"] = 2
    real = program.server

    def coarse_server(cfg, device, tmp):
        cfg = copy.deepcopy(cfg)
        cfg["pyin"]["resolution"] = 0.1
        return real(cfg, device, tmp)

    monkeypatch.setattr(program, "server", coarse_server)
    run.set_cache_dirs()
    res = run.run_cell(BENCH, "v1_fine_rest", SEED, 2.0, 0, "cpu", False,
                       cfg, mix)
    checks = res["checks"]
    assert not res["correct"]
    assert checks["state_miss_pct"]["value"] > checks["state_miss_pct"][
        "limit"], checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "state_miss_pct"), checks
