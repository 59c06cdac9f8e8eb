"""CPU tests of the readers of the trough kernel's device time
(``metrics/trough_obs_ms.*.py``) on synthetic traced slices.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import readers, run  # noqa: E402
from bench_torch.trace import Slice  # noqa: E402

TROUGH = ("(anonymous namespace)::trough_obs_kernel(float const*, bool "
          "const*, long const*, float const*, float const*, float*, int, "
          "int, int, int, int, float, float, float)")
FWD = "void (anonymous namespace)::viterbi_fwd_kernel<8, 8, true>(...)"
CFG = run.load_json(run.HERE / "configs" / "v1_mono_44k.json")
BENCH = run.load_json(run.HERE.parent / "BENCHMARK.json")


def _slice(ops, n_items=4):
    items = [{"t0": 0.0, "t1": 1e9, "decodes": [(1, 40)]}
             for _ in range(n_items)]
    return Slice(ops=ops, t0=0.0, t1=1e9, items=items, spans=[], cfg=CFG)


@pytest.mark.parametrize("name", ["trough_obs_ms.request",
                                  "trough_obs_ms.live"])
def test_trough_ms_is_the_kernels_device_time_a_unit(name):
    read = run.load_file_module(run.HERE / "metrics" / f"{name}.py").read
    sl = _slice([(TROUGH, 0.0, 0.2e6), (FWD, 0.2e6, 0.4e6),
                 (TROUGH, 1e6, 1.2e6), ("elementwise", 2e6, 3e6)])
    assert read(sl) == pytest.approx(0.4 / 4)
    # a program without the kernel (the parent) reads nothing
    assert read(_slice([(FWD, 0.0, 1e6), ("elementwise", 1e6, 2e6)])) is None
    assert read(_slice([])) is None


def test_the_trough_kernel_moves_no_viterbi_reading():
    """The Viterbi readers match kernels by substring: the trough kernel's
    name holds none of theirs, so its time counts in none of them."""
    sl = _slice([(TROUGH, 0.0, 5e6), (FWD, 5e6, 6e6)])
    alone = _slice([(FWD, 5e6, 6e6)])
    assert readers.viterbi_roofline_pct(sl) == readers.viterbi_roofline_pct(
        alone)
    assert readers.kernel_launches_per_unit(sl) == \
        readers.kernel_launches_per_unit(alone)
    assert not any(t in TROUGH for t in ("viterbi", "_fwd"))


def test_the_metrics_name_the_cells_that_run_the_kernel():
    got = {m["name"]: m for m in BENCH["per_layer"]
           if m["name"].startswith("trough_obs_ms")}
    assert got["trough_obs_ms.request"]["workloads"] == ["v1_rest_mono",
                                                         "v1_fine_rest"]
    assert got["trough_obs_ms.live"]["workloads"] == ["v1_live_mono"]
    assert {m["layer"] for m in got.values()} == {"device programs"}
