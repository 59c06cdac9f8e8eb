"""Device-side "financial" trend/noise filters (PyTorch).

Counterpart of ``aegis_tpu/core/trend.py``, function for function, on
``(..., T)`` tensors: time on dim -1, any leading batch (the tiled and
batch programs run one row per track).

  * Recurrent filters (EMA, Kalman, Holt-Winters, Wilder RSI) are affine
    recurrences y[t] = a[t]*y[t-1] + b[t], evaluated by a log-depth
    doubling (Hillis-Steele) scan: ceil(log2 T) elementwise steps, where a
    sequential loop would be T launches.  The JAX package uses
    ``jax.lax.associative_scan``; torch has no public equivalent.
  * Holt-Winters' 2-state recurrence composes 2x2 maps as explicit
    elementwise products, so no matmul (and no TF32) touches it.
  * SMA and Savitzky-Golay are float32 shifted sums over their taps, in
    the order of XLA's CPU convolution: the JAX package pins
    ``Precision.HIGHEST`` on those convolutions, and a ``conv1d`` here
    would follow the global TF32 flag.
  * Windowed variances are two-pass (each window's mean first), as in the
    JAX package; the one-pass E[x^2]-E[x]^2 form cost 0.08 of financial
    confidence against the float64 oracle.
  * ``torch.argmax`` takes no bool input, so masks are cast to int32
    first; it returns the first maximal index, as ``jnp.argmax`` does.

Semantics contract: the CPU oracle ``aegis_tpu.ref.trend_ref``.  NaN
convention: f0 is NaN on unvoiced frames throughout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aegis_tpu_torch.core.tables import kalman_gain_table, savgol_taps

NAN = float("nan")

# Articulation / slide codes (shared with ref.trend_ref)
ARTIC_NONE, ARTIC_NORMAL, ARTIC_BEND, ARTIC_VIBRATO, ARTIC_NOISE = 0, 1, 2, 3, 4
SLIDE_NONE, SLIDE_UP, SLIDE_DOWN, SLIDE_NORMAL = 0, 1, 2, 3


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim -1 (0 when there is none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] with one index per row: idx has x's leading shape."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _cummax(x: torch.Tensor) -> torch.Tensor:
    """Running max along dim -1 (``jax.lax.cummax``)."""
    return torch.cummax(x, dim=-1).values


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[..., t - d] with ``fill`` for t < d."""
    head = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([head, x[..., :-d]], dim=-1)


def _affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[t] = a[t] * y[t-1] + b[t] with y[-1] = 0, in log depth.

    Affine maps compose associatively: (a2,b2)∘(a1,b1) = (a1*a2, a2*b1+b2).
    After the step at distance d, element t holds the composition of
    elements (t-2d, t]; the identity (1, 0) fills in before the start.
    Callers encode "reset to v" as (a=0, b=v) and "skip" as (a=1, b=0);
    b must be finite everywhere so 0*NaN can never poison a later segment.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    T = a.shape[-1]
    d = 1
    while d < T:
        a_l, b_l = _shift_right(a, d, 1.0), _shift_right(b, d, 0.0)
        a, b = a_l * a, a * b_l + b
        d *= 2
    return b


def _affine_scan_2x2(M: Tuple[torch.Tensor, ...], v: Tuple[torch.Tensor, ...],
                     init: Tuple[torch.Tensor, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State recurrence s[t] = M[t] @ s[t-1] + v[t], s[-1] = init, log depth.

    M = (m00, m01, m10, m11) and v = (v0, v1), each (..., T); init is
    (s0, s1), each (...,).  Compositions are written out elementwise:
    combine(left, right) = (M_r @ M_l, M_r @ v_l + v_r).  Returns the two
    state rows, each (..., T).
    """
    m00, m01, m10, m11 = M
    v0, v1 = v
    T = m00.shape[-1]
    d = 1
    while d < T:
        l00, l01 = _shift_right(m00, d, 1.0), _shift_right(m01, d, 0.0)
        l10, l11 = _shift_right(m10, d, 0.0), _shift_right(m11, d, 1.0)
        lv0, lv1 = _shift_right(v0, d, 0.0), _shift_right(v1, d, 0.0)
        m00, m01, m10, m11, v0, v1 = (
            m00 * l00 + m01 * l10, m00 * l01 + m01 * l11,
            m10 * l00 + m11 * l10, m10 * l01 + m11 * l11,
            m00 * lv0 + m01 * lv1 + v0, m10 * lv0 + m11 * lv1 + v1)
        d *= 2
    s0, s1 = init[0][..., None], init[1][..., None]
    return m00 * s0 + m01 * s1 + v0, m10 * s0 + m11 * s1 + v1


def _trailing_window(x: torch.Tensor, w: int, include_current: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gathered trailing windows.  Returns (vals (..., T, w), valid_pos
    (T, w)).

    include_current=True  -> window [i-w+1, i]
    include_current=False -> window [i-w, i-1]
    """
    T = x.shape[-1]
    idx = torch.arange(T, device=x.device)[:, None]
    lo = -w + 1 if include_current else -w
    pos = idx + torch.arange(lo, lo + w, device=x.device)[None, :]
    return x[..., torch.clamp(pos, 0, T - 1)], pos >= 0


def _tree_sum(terms):
    """Adjacent pairs first, then halving: ((t0+t1)+(t4+t5))+((t2+t3)+(t6+t7))
    for eight terms."""
    if len(terms) > 1:
        terms = [terms[2 * i] + terms[2 * i + 1]
                 for i in range(len(terms) // 2)]
    while len(terms) > 1:
        h = len(terms) // 2
        terms = [terms[i] + terms[i + h] for i in range(h)]
    return terms[0]


def _correlate(xp: torch.Tensor, taps, T: int) -> torch.Tensor:
    """out[i] = sum_l taps[l] * xp[i + l], i < T, as float32 shifted sums
    over an already padded row.

    The terms are added in the order of XLA's CPU convolution (lanes of 8,
    then 4, then 2, each reduced by _tree_sum, then single terms), which
    the JAX package's ``jnp.convolve`` runs on the CPU (bit for bit from 3
    to 16 taps; the pipeline uses 10 and 11): on a held pitch a Bollinger
    band has zero width, and whether f0 sits above or below the moving
    average is then decided by the last bit of that sum."""
    terms = [xp[..., l:l + T] * taps[l] for l in range(len(taps))]
    out, k = None, 0
    for lanes in (8, 4, 2):
        n = (len(terms) - k) // lanes
        if n == 0:
            continue
        acc = terms[k:k + lanes]
        for v in range(1, n):
            acc = [acc[j] + terms[k + lanes * v + j] for j in range(lanes)]
        s = _tree_sum(acc)
        out = s if out is None else out + s
        k += lanes * n
    for t in terms[k:]:
        out = t if out is None else out + t
    return out


# ---------------------------------------------------------------- moving avgs

def sma(data: torch.Tensor, window: int = 5) -> torch.Tensor:
    """np.convolve(valid, ones(w)/w, "same"), NaN restored."""
    nan = torch.isnan(data)
    valid = torch.where(nan, 0.0, data)
    left = window - 1 - (window - 1) // 2
    xp = torch.nn.functional.pad(valid, (left, window - 1 - left))
    # 1/w rounded to float32, as jnp.ones((w,)) / w
    tap = torch.tensor(1.0 / window, dtype=torch.float32).item()
    out = _correlate(xp, (tap,) * window, data.shape[-1])
    return torch.where(nan, NAN, out)


def ema(data: torch.Tensor, span: int = 5) -> torch.Tensor:
    """EMA with NaN-gap reset (see ref.trend_ref.ema), as an affine scan.

    Every valid sample that follows a NaN (or t=0) is a segment start
    emitting x verbatim, (a=0, b=x); other valid samples are (1-α, αx);
    NaN samples contribute (0, 0) and get their NaN re-applied afterwards.
    """
    alpha = 2.0 / (span + 1.0)
    data = data.to(torch.float32)
    valid = ~torch.isnan(data)
    start = valid & ~_shift_right(valid, 1, False)
    x = torch.where(valid, data, 0.0)
    a = torch.where(start | ~valid, 0.0, 1.0 - alpha)
    b = torch.where(start, x, torch.where(valid, alpha * x, 0.0))
    return torch.where(valid, _affine_scan(a, b), NAN)


def _rolling_std_trailing(data: torch.Tensor, window: int) -> torch.Tensor:
    """NaN-aware std over trailing windows [i-window+1, i]; NaN when < 2
    valid.  Per-window TWO-PASS variance (each window's mean first)."""
    valid = ~torch.isnan(data)
    v = torch.where(valid, data, 0.0)
    vals, _ = _trailing_window(v, window, include_current=True)
    mask, in_range = _trailing_window(valid.to(torch.float32), window, True)
    mask = mask * in_range
    cnt = torch.sum(mask, dim=-1)
    c = torch.clamp_min(cnt, 1.0)
    mean_w = torch.sum(vals * mask, dim=-1) / c
    dev = (vals - mean_w[..., None]) * mask
    var = torch.sum(dev * dev, dim=-1) / c
    return torch.where(cnt > 1, torch.sqrt(var), NAN)


def bollinger(data: torch.Tensor, window: int = 20, num_std: float = 2.0):
    ma = sma(data, window)
    std = _rolling_std_trailing(data, window)
    return ma, ma + num_std * std, ma - num_std * std


# -------------------------------------------------------------- articulations

def detect_articulation_bollinger(f0: torch.Tensor, window: int = 10,
                                  sensitivity: float = 2.0) -> torch.Tensor:
    """(..., T) int8 articulation codes.  The reference's state machine
    carry (prev_state, counter) advances only on valid frames, so both
    resolve to gathers over the valid-frame subsequence."""
    _, upper, lower = bollinger(f0, window, sensitivity)
    above = (~torch.isnan(upper)) & (f0 > upper)
    below = (~torch.isnan(lower)) & (f0 < lower)
    state = torch.where(above, 1, torch.where(below, 2, 0)).to(torch.int32)
    valid = ~torch.isnan(f0)
    T = f0.shape[-1]
    idx = torch.arange(T, device=f0.device).expand(f0.shape)

    last_valid = _cummax(torch.where(valid, idx, -1))
    prev_valid = _shift_right(last_valid, 1, -1)
    prev_state = torch.where(prev_valid >= 0,
                             torch.gather(state, -1,
                                          torch.clamp(prev_valid, 0, T - 1)),
                             0)
    crossed = valid & (prev_state != state) & (prev_state != 0)

    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    zero_rank = _cummax(torch.where(valid & ~crossed, rank, -1))
    counter = rank - zero_rank

    artic = torch.where(
        counter >= 2, ARTIC_VIBRATO,
        torch.where(state == 1, ARTIC_BEND,
                    torch.where(state == 2, ARTIC_NOISE, ARTIC_NORMAL)))
    return torch.where(valid, artic, ARTIC_NONE).to(torch.int8)


# ---------------------------------------------------------------------- MACD

def macd(data: torch.Tensor, fast: int = 12, slow: int = 26, signal: int = 9):
    macd_line = ema(data, fast) - ema(data, slow)
    signal_line = ema(macd_line, signal)
    return macd_line, signal_line, macd_line - signal_line


def detect_slides_macd(f0: torch.Tensor, threshold: float = 0.5
                       ) -> torch.Tensor:
    semis = 12.0 * torch.log2(f0 / 440.0) + 69.0  # NaN propagates
    macd_line, _, hist = macd(semis, fast=5, slow=20, signal=9)
    out = torch.where(
        (macd_line > threshold) & (hist > 0), SLIDE_UP,
        torch.where((macd_line < -threshold) & (hist < 0), SLIDE_DOWN,
                    SLIDE_NORMAL))
    return torch.where(torch.isnan(macd_line), SLIDE_NONE, out).to(torch.int8)


# ----------------------------------------------------------------------- RSI

def rsi(data: torch.Tensor, period: int = 14) -> torch.Tensor:
    """Wilder-smoothed RSI as an affine scan, 50 for the first ``period``
    frames (and everywhere when T <= period)."""
    n = data.shape[-1]
    if n <= period:
        return torch.full(data.shape, 50.0, device=data.device)
    deltas = torch.diff(data.to(torch.float32), dim=-1)
    gains = torch.clamp_min(deltas, 0.0)
    losses = torch.clamp_min(-deltas, 0.0)

    init_g = torch.mean(gains[..., :period], dim=-1, keepdim=True)
    init_l = torch.mean(losses[..., :period], dim=-1, keepdim=True)

    # avg' = avg*(p-1)/p + g/p, seeded with (a=0, b=init)
    a_const = (period - 1.0) / period
    a = torch.full(init_g.shape[:-1] + (n - period,), a_const,
                   device=data.device)
    a[..., 0] = 0.0
    avg_g = _affine_scan(a, torch.cat([init_g, gains[..., period:] / period],
                                      dim=-1))
    avg_l = _affine_scan(a, torch.cat([init_l, losses[..., period:] / period],
                                      dim=-1))
    vals = torch.where(
        avg_l == 0, 100.0,
        100.0 - 100.0 / (1.0 + avg_g / torch.clamp_min(avg_l, 1e-30)))
    head = torch.full(vals.shape[:-1] + (period,), 50.0, device=data.device)
    return torch.cat([head, vals], dim=-1)


# -------------------------------------------------------------- noise filters

def kalman(data: torch.Tensor, process_variance: float = 1e-5,
           measurement_variance: float = 1e-1) -> torch.Tensor:
    """Scalar Kalman with NaN skip, as an affine scan.

    The gain of the j-th valid sample is a constant of the length
    (tables.kalman_gain_table); gathered by the running valid count, the
    state path becomes x' = (1-k_j)x + k_j z.  The first valid sample
    yields exactly z, encoded (a=0, b=z).
    """
    data = data.to(torch.float32)
    T = data.shape[-1]
    valid = ~torch.isnan(data)
    k_table = kalman_gain_table(T, process_variance, measurement_variance,
                                data.device)
    j = torch.cumsum(valid.to(torch.int64), dim=-1)  # 1-indexed valid rank
    k = k_table[j]
    z = torch.where(valid, data, 0.0)
    first = valid & (j == 1)
    a = torch.where(first, 0.0, torch.where(valid, 1.0 - k, 1.0))
    b = torch.where(first, z, torch.where(valid, k * z, 0.0))
    out = torch.where(valid, _affine_scan(a, b), NAN)
    return torch.where(valid.any(dim=-1, keepdim=True), out, data)


def holt_winters(data: torch.Tensor, alpha: float = 0.3,
                 beta: float = 0.1) -> torch.Tensor:
    """Holt's linear trend, (level, trend) as a 2-state affine recurrence:
        level' = αx + (1-α)level + (1-α)trend
        trend' = βαx −  βα level + (1-βα)trend
    NaN samples apply the identity map.  Rows with < 2 valid samples are
    returned unchanged."""
    data = data.to(torch.float32)
    valid = ~torch.isnan(data)
    idx = torch.arange(data.shape[-1], device=data.device)
    fv0 = _first_true(valid)
    fv1 = _first_true(valid & (idx > fv0[..., None]))
    enough = valid.sum(dim=-1, keepdim=True) >= 2
    level0 = _take(data, fv0)
    trend0 = _take(data, fv1) - level0

    x = torch.where(valid, data, 0.0)

    def coef(c: float, identity: float) -> torch.Tensor:
        return torch.where(valid, c, identity)  # c rounds to float32

    M = (coef(1 - alpha, 1.0), coef(1 - alpha, 0.0),
         coef(-beta * alpha, 0.0), coef(1 - beta * alpha, 1.0))
    v = (torch.where(valid, alpha * x, 0.0),
         torch.where(valid, beta * alpha * x, 0.0))
    level, _ = _affine_scan_2x2(M, v, (level0, trend0))
    out = torch.where(valid, level, NAN)
    return torch.where(enough, out, data)


def forward_fill(data: torch.Tensor) -> torch.Tensor:
    """Hold-last-value fill; leading NaNs back-filled with the first valid."""
    T = data.shape[-1]
    valid = ~torch.isnan(data)
    idx = torch.arange(T, device=data.device).expand(data.shape)
    lvi = _cummax(torch.where(valid, idx, -1))
    filled = torch.gather(data, -1, torch.clamp(lvi, 0, T - 1))
    first = _take(data, _first_true(valid))
    return torch.where(lvi >= 0, filled, first[..., None])


def savgol(data: torch.Tensor, window: int = 11,
           polyorder: int = 3) -> torch.Tensor:
    """Savitzky-Golay on forward-filled data, NaNs restored; all-NaN when
    fewer than `window` valid samples (see ref.trend_ref docstring)."""
    valid = ~torch.isnan(data)
    filled = forward_fill(data)
    half = window // 2
    T = data.shape[-1]
    # edge padding, then the taps as a correlation over the window
    padded = torch.cat([filled[..., :1].expand(filled.shape[:-1] + (half,)),
                        filled,
                        filled[..., -1:].expand(filled.shape[:-1] + (half,))],
                       dim=-1)
    out = torch.where(valid, _correlate(padded, savgol_taps(window, polyorder),
                                        T), NAN)
    enough = valid.sum(dim=-1, keepdim=True) > window
    return torch.where(enough, out, NAN)


def atr_filter(data: torch.Tensor, window: int = 14, threshold: float = 2.0):
    """(filtered, noise_mask): spike suppression with hold-last replacement."""
    n = data.shape[-1]
    tr = torch.abs(torch.diff(data, dim=-1))  # length n-1, NaN propagates
    tr_valid = ~torch.isnan(tr)
    trv = torch.where(tr_valid, tr, 0.0)
    zero = torch.zeros_like(trv[..., :1])
    cum = torch.cat([zero, torch.cumsum(trv, dim=-1)], dim=-1)
    cnt = torch.cat([zero, torch.cumsum(tr_valid.to(torch.float32), dim=-1)],
                    dim=-1)
    i = torch.arange(n, device=data.device)
    lo = torch.clamp_min(i - window, 0)
    hi = torch.clamp_max(i, n - 1)  # window tr[lo:i]
    s = cum[..., hi] - cum[..., lo]
    c = cnt[..., hi] - cnt[..., lo]
    atr = torch.where((i >= window) & (i < n - 1) & (c > 0),
                      s / torch.clamp_min(c, 1), NAN)

    prev_vals = torch.cat([data[..., :1], data[..., :-1]], dim=-1)
    noise = (~torch.isnan(atr)) & (~torch.isnan(data)) & (
        torch.abs(data - prev_vals) > atr * threshold)
    noise[..., 0] = False

    # hold-last-value = gather at the most recent non-noise index
    # (noise[0] is forced False so the cummax is always >= 0)
    keep_idx = _cummax(torch.where(noise, -1, i.expand(noise.shape)))
    return torch.gather(data, -1, keep_idx), noise


def ichimoku_baseline(data: torch.Tensor, kijun: int = 26) -> torch.Tensor:
    T = data.shape[-1]
    vals, in_range = _trailing_window(data, kijun, include_current=False)
    ok = in_range & ~torch.isnan(vals)
    hi = torch.amax(torch.where(ok, vals, -torch.inf), dim=-1)
    lo = torch.amin(torch.where(ok, vals, torch.inf), dim=-1)
    has = ok.any(dim=-1) & (torch.arange(T, device=data.device) >= kijun)
    return torch.where(has, (hi + lo) / 2.0, NAN)


def stochastic(data: torch.Tensor, k_period: int = 14,
               smooth: int = 3) -> torch.Tensor:
    T = data.shape[-1]
    t = torch.arange(T, device=data.device)
    any_valid = (~torch.isnan(data)).any(dim=-1, keepdim=True)
    vals, in_range = _trailing_window(data, k_period + 1, include_current=True)
    ok = in_range & ~torch.isnan(vals)
    hi = torch.amax(torch.where(ok, vals, -torch.inf), dim=-1)
    lo = torch.amin(torch.where(ok, vals, torch.inf), dim=-1)
    k_raw = (data - lo) / (hi - lo) * 100.0  # NaN where data NaN
    use = (t >= k_period) & ok.any(dim=-1) & (hi - lo > 0)
    k_values = torch.where(use, k_raw, 50.0)

    dvals, dir_ok = _trailing_window(k_values, smooth + 1, include_current=True)
    d_raw = torch.sum(torch.where(dir_ok, dvals, 0.0), dim=-1) / torch.clamp_min(
        torch.sum(dir_ok, dim=-1), 1)
    # np.mean over a window containing NaN propagates NaN
    has_nan = (dir_ok & torch.isnan(dvals)).any(dim=-1)
    d_values = torch.where(t >= smooth, torch.where(has_nan, NAN, d_raw), 50.0)
    return torch.where(any_valid, d_values, 50.0)


# ------------------------------------------------------------------ consensus

def _nan_stats3(a, b, c):
    """(nanmedian, nanstd) across three arrays, elementwise."""
    stack = torch.stack([a, b, c])
    valid = ~torch.isnan(stack)
    cnt = valid.sum(dim=0)
    s = torch.sort(torch.where(valid, stack, torch.inf), dim=0).values
    median = torch.where(
        cnt == 3, s[1],
        torch.where(cnt == 2, (s[0] + s[1]) / 2.0,
                    torch.where(cnt == 1, s[0], NAN)))
    v = torch.where(valid, stack, 0.0)
    c1 = torch.clamp_min(cnt, 1)
    mean = v.sum(dim=0) / c1
    # two-pass variance: avoids f32 cancellation at Hz magnitudes
    dev = torch.where(valid, stack - mean, 0.0)
    var = (dev * dev).sum(dim=0) / c1
    std = torch.where(cnt > 0, torch.sqrt(var), NAN)
    return median, std


def multi_filter_consensus(data: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    consensus, std = _nan_stats3(savgol(data), kalman(data),
                                 holt_winters(data))
    return consensus, 1.0 / (1.0 + std)


def bollinger_confidence(f0: torch.Tensor, window: int = 10) -> torch.Tensor:
    _, upper, lower = bollinger(f0, window)
    bw = upper - lower
    conf = torch.where(bw > 0, 1.0 / (1.0 + bw), 1.0)
    return torch.where(torch.isnan(f0) | torch.isnan(bw), 0.0, conf)


def analyze_pitch_financial(f0_clean: torch.Tensor) -> dict:
    """Integrated financial analysis of (..., T) f0 rows (NaN unvoiced)."""
    trend, filter_conf = multi_filter_consensus(f0_clean)
    return {
        "trend": trend,
        "filter_confidence": filter_conf,
        "articulations": detect_articulation_bollinger(f0_clean, window=10),
        "slides": detect_slides_macd(f0_clean, threshold=0.3),
        "confidence": bollinger_confidence(f0_clean, window=10),
    }


def adaptive_confidence_threshold(conf: torch.Tensor) -> torch.Tensor:
    """Bollinger-style adaptive threshold clip(mean - std, 0.3, 0.8) over
    the positive entries of each row (0.5 for a row with none); one value
    per leading index.  The one-pass moment form is the JAX package's."""
    pos = conf > 0
    cnt = pos.sum(dim=-1)
    c = torch.clamp_min(cnt, 1)
    mean = torch.where(pos, conf, 0.0).sum(dim=-1) / c
    var = torch.clamp_min(
        torch.where(pos, conf * conf, 0.0).sum(dim=-1) / c - mean * mean, 0.0)
    thr = torch.clamp(mean - torch.sqrt(var), 0.3, 0.8)
    return torch.where(cnt > 0, thr, 0.5)
