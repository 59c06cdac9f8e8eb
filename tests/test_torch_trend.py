"""aegis_tpu_torch's financial trend stack vs the JAX package's
``core/trend.py`` and the NumPy oracle ``ref/trend_ref.py``, at
tests/test_trend_parity.py's tolerances, plus the batch contract: rows of
a (B, T) batch equal the rows run one at a time."""

import numpy as np
import pytest
import torch

from aegis_tpu.core import trend as J
from aegis_tpu.ref import trend_ref as R
from aegis_tpu_torch.core import trend as P

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def noisy_pitch():
    rng = np.random.default_rng(7)
    x = 220 + np.cumsum(rng.normal(0, 2, 300))
    x[40:55] = np.nan
    x[120] = np.nan
    x[200:203] = np.nan
    return x


def _cmp(a, b, tol=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert (np.isnan(a) == np.isnan(b)).all(), "NaN placement mismatch"
    both = ~np.isnan(a)
    if both.any():
        assert np.max(np.abs(a[both] - b[both])) < tol


def _port(fn, x, *args):
    out = fn(torch.from_numpy(np.asarray(x, np.float32)), *args)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


# name -> (port fn, JAX fn, oracle fn, extra args, tolerance); each output
# of a tuple-valued function is compared
ROWS = {
    "sma": (P.sma, J.sma, R.sma, (), 1e-3),
    "sma_w10": (P.sma, J.sma, R.sma, (10,), 1e-3),
    "ema": (P.ema, J.ema, R.ema, (), 1e-3),
    "bollinger": (P.bollinger, J.bollinger, R.bollinger, (10,), 5e-3),
    "macd": (P.macd, J.macd, R.macd, (), 5e-3),
    "kalman": (P.kalman, J.kalman, R.kalman, (), 1e-3),
    "holt_winters": (P.holt_winters, J.holt_winters, R.holt_winters, (), 5e-3),
    "forward_fill": (P.forward_fill, J.forward_fill, R.forward_fill, (), 1e-3),
    "savgol": (P.savgol, J.savgol, R.savgol, (), 5e-3),
    "ichimoku": (P.ichimoku_baseline, J.ichimoku_baseline,
                 R.ichimoku_baseline, (), 5e-3),
    "stochastic": (P.stochastic, J.stochastic, R.stochastic, (), 1e-2),
    "consensus": (P.multi_filter_consensus, J.multi_filter_consensus,
                  R.multi_filter_consensus, (), 1e-2),
    "bollinger_confidence": (P.bollinger_confidence, J.bollinger_confidence,
                             R.bollinger_confidence, (), 1e-3),
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_rows_match_jax_and_oracle(noisy_pitch, name):
    port_fn, jax_fn, ref_fn, args, tol = ROWS[name]
    got = _port(port_fn, noisy_pitch, *args)
    jax_out = jax_fn(noisy_pitch.astype(np.float32), *args)
    ref = ref_fn(noisy_pitch, *args)
    if not isinstance(got, tuple):
        got, jax_out, ref = (got,), (jax_out,), (ref,)
    for g, j, r in zip(got, jax_out, ref):
        _cmp(g, j, 1e-4)
        _cmp(g, r, tol)


def test_articulation_codes(noisy_pitch):
    got = _port(P.detect_articulation_bollinger, noisy_pitch)
    aj = np.asarray(J.detect_articulation_bollinger(noisy_pitch.astype(np.float32)))
    ar = R.detect_articulation_bollinger(noisy_pitch)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, aj)
    assert (got == ar).mean() > 0.99  # rare band-edge float ties allowed


def test_articulation_on_held_pitch_matches_jax():
    """A held pitch gives zero-width Bollinger bands, where the last bit of
    the moving average decides the code: the port sums in XLA's order."""
    f0 = np.repeat(np.float32([82.40689, 293.6648, 261.62558, 110.0]), 40)
    f0[70:75] = np.nan
    got = _port(P.detect_articulation_bollinger, f0)
    np.testing.assert_array_equal(
        got, np.asarray(J.detect_articulation_bollinger(f0)))


def test_slides(noisy_pitch):
    got = _port(P.detect_slides_macd, noisy_pitch, 0.3)
    np.testing.assert_array_equal(
        got, np.asarray(J.detect_slides_macd(noisy_pitch.astype(np.float32), 0.3)))
    assert (got == R.detect_slides_macd(noisy_pitch, 0.3)).mean() > 0.99


@pytest.mark.parametrize("n", [5, 14, 15, 120])
def test_rsi(n):
    """RSI against both packages, including T <= period (all 50)."""
    d = np.abs(np.random.default_rng(3).normal(2, 1, n))
    got = _port(P.rsi, d)
    _cmp(got, J.rsi(d.astype(np.float32)), 1e-3)
    _cmp(got, R.rsi(d), 1e-2)
    if n <= 14:
        assert (got == 50.0).all()


def test_atr(noisy_pitch):
    fp, nv = _port(P.atr_filter, noisy_pitch)
    fr, nr = R.atr_filter(noisy_pitch)
    fj, nj = J.atr_filter(noisy_pitch.astype(np.float32))
    np.testing.assert_array_equal(nv, nr)
    np.testing.assert_array_equal(nv, np.asarray(nj))
    _cmp(fp, fr)
    _cmp(fp, fj, 1e-4)


def test_adaptive_threshold(noisy_pitch):
    conf = R.bollinger_confidence(noisy_pitch).astype(np.float32)
    got = float(P.adaptive_confidence_threshold(torch.from_numpy(conf)))
    assert abs(got - R.adaptive_confidence_threshold(conf)) < 1e-4
    assert abs(got - float(J.adaptive_confidence_threshold(conf))) < 1e-6


def test_analyze_pitch_financial_matches_jax(noisy_pitch):
    x = noisy_pitch.astype(np.float32)
    got = P.analyze_pitch_financial(torch.from_numpy(x))
    ref = J.analyze_pitch_financial(x)
    assert got.keys() == ref.keys()
    for k in ref:
        if k in ("articulations", "slides"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        else:
            _cmp(got[k].numpy(), ref[k], 1e-4)


def _batch_rows(noisy_pitch):
    x = noisy_pitch.astype(np.float32)
    other = (x[::-1] * 1.5).copy()
    held = np.full_like(x, 146.83)
    held[:30] = np.nan
    return np.stack([x, other, held])


BATCHED = {
    "analyze_pitch_financial": lambda t: P.analyze_pitch_financial(t),
    "rsi": lambda t: {"rsi": P.rsi(torch.nan_to_num(t))},
    "atr": lambda t: dict(zip(("filtered", "noise"), P.atr_filter(t))),
    "stochastic": lambda t: {"k": P.stochastic(t)},
    "ichimoku": lambda t: {"base": P.ichimoku_baseline(t)},
    "adaptive_threshold": lambda t: {"thr": P.adaptive_confidence_threshold(
        P.bollinger_confidence(t))},
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batch_of_three_equals_rows_one_at_a_time(noisy_pitch, name):
    rows = _batch_rows(noisy_pitch)
    fn = BATCHED[name]
    batch = fn(torch.from_numpy(rows))
    for i, row in enumerate(rows):
        single = fn(torch.from_numpy(row))
        for k, v in single.items():
            np.testing.assert_array_equal(batch[k][i].numpy(), v.numpy(),
                                          err_msg=f"{name}.{k} row {i}")


def test_all_nan_row_matches_jax():
    x = np.full(64, np.nan, np.float32)
    got = P.analyze_pitch_financial(torch.from_numpy(x))
    ref = J.analyze_pitch_financial(x)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    conf = P.bollinger_confidence(torch.from_numpy(x))
    assert float(P.adaptive_confidence_threshold(conf)) == 0.5
    for fn in (P.kalman, P.holt_winters, P.savgol, P.ema, P.sma):
        assert torch.isnan(fn(torch.from_numpy(x))).all()


@pytest.mark.parametrize("name", ["atr_filter", "ichimoku_baseline",
                                  "stochastic"])
def test_copied_filters_equal_the_reference(noisy_pitch, name):
    """The ATR, Ichimoku and stochastic filters complete the copy of
    ``ref/trend_ref.py``: the same arrays as the original's."""
    from aegis_tpu_torch.ref import trend_ref as T

    x = noisy_pitch.copy()
    x[150] += 40.0   # a spike for the ATR filter
    got, ref = getattr(T, name)(x), getattr(R, name)(x)
    for g, r in zip(*((got, ref) if isinstance(ref, tuple) else
                      ((got,), (ref,)))):
        np.testing.assert_array_equal(g, r)
    if name == "atr_filter":
        assert ref[1].any()
    all_nan = np.full(40, np.nan)
    for g, r in zip(np.atleast_1d(getattr(T, name)(all_nan)),
                    np.atleast_1d(getattr(R, name)(all_nan))):
        np.testing.assert_array_equal(g, r)
