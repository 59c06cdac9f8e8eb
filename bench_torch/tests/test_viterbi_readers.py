"""CPU tests of the readers of the decode's forward kernels
(``viterbi_readers.py``) on synthetic traced slices.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import program_spans, roofline, run, viterbi_readers  # noqa: E402
from bench_torch.trace import Slice  # noqa: E402

FINE = run.load_json(run.HERE / "configs" / "v1_fine_44k.json")
ONE = "void (anonymous namespace)::viterbi_fwd_kernel<8, 16, true, float>(...)"
WIDE = ("void (anonymous namespace)::viterbi_fwd_wide_kernel<8, 16, true, "
        "float>(...)")
BACK = "void (anonymous namespace)::viterbi_back_walk_kernel(...)"


def _slice(ops, n_items=2, T=5249):
    items = [{"t0": 0.0, "t1": 1e9, "decodes": [(1, T)]}
             for _ in range(n_items)]
    return Slice(ops=ops, t0=0.0, t1=1e9, items=items, spans=[], cfg=FINE)


def test_forward_ms_sums_both_forward_kernels():
    sl = _slice([(ONE, 0.0, 3e6), (WIDE, 4e6, 9e6), (BACK, 9e6, 10e6),
                 ("elementwise", 10e6, 20e6)])
    assert viterbi_readers.forward_ms_per_unit(sl) == pytest.approx(4.0)
    assert viterbi_readers.forward_ms_per_unit(_slice([])) is None


def test_wide_roofline_is_none_without_the_wide_kernel():
    sl = _slice([(ONE, 0.0, 12e6), (BACK, 12e6, 13e6)])
    assert viterbi_readers.wide_roofline_pct(sl) is None


def test_wide_roofline_is_the_forward_bound_over_the_wide_kernels_time():
    sl = _slice([(WIDE, 0.0, 24e6), (WIDE, 30e6, 54e6), (BACK, 70e6, 71e6),
                 ("elementwise", 71e6, 90e6)])
    n, w = roofline.pitch_grid(FINE["pyin"], 44100, 512)
    assert (n, w) == (900, 101)
    bound = 2 * roofline.seconds(*roofline.forward_bound(1, 5249, n, w))
    assert viterbi_readers.wide_roofline_pct(sl) == pytest.approx(
        100.0 * bound / 48e-3)
    # the wide kernel's H100 reading at this shape, 23.92 ms: ~0.23 %
    assert 0.1 < viterbi_readers.wide_roofline_pct(sl) < 0.5


def test_wide_roofline_is_none_where_the_one_pass_kernel_ran_beside_it():
    """A slice whose decodes are not all the wide kernel's (a batch at
    n = 900 takes the one-pass kernel) would count them all over the wide
    kernel's time alone."""
    sl = _slice([(WIDE, 0.0, 24e6), (ONE, 30e6, 31e6), (BACK, 31e6, 32e6)])
    assert viterbi_readers.wide_roofline_pct(sl) is None


def test_the_forward_kernels_are_the_data_files():
    names = run.load_json(run.HERE / "metrics" / "viterbi_kernels.json")
    assert viterbi_readers.FORWARD == ("viterbi_fwd_kernel",
                                       "viterbi_fwd_wide_kernel")
    assert set(viterbi_readers.FORWARD) <= set(names["kernels"])
    assert viterbi_readers.WIDE == "viterbi_fwd_wide_kernel"


class _Span:
    def __init__(self, name, start_ns, kernel=None):
        self.name, self.start_ns = name, start_ns
        self.attrs = {} if kernel is None else {"kernel": kernel}


def test_wide_decodes_count_the_spans_naming_the_wide_kernel(monkeypatch):
    sl = _slice([(WIDE, 0.0, 1e6)], n_items=4)
    spans = [_Span("aegis.viterbi", 1.0, "viterbi_fwd_wide_kernel"),
             _Span("aegis.viterbi", 2.0, "viterbi_fwd_wide_kernel"),
             _Span("aegis.viterbi", 3.0, "viterbi_fwd_kernel"),
             _Span("aegis.enqueue", 4.0)]
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: spans)
    assert viterbi_readers.wide_decodes_per_unit(sl) == 0.5
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: spans[2:])
    assert viterbi_readers.wide_decodes_per_unit(sl) == 0.0
    # a program without the span: nothing to read
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: spans[3:])
    assert viterbi_readers.wide_decodes_per_unit(sl) is None
