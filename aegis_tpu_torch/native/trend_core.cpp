// Native trend-filter recurrences: the C++ counterpart of the strictly
// sequential Python loops in ref/trend_ref.py (the "financial" noise-filter
// stack), and a copy of aegis_tpu/native/trend_core.cpp.  The live financial
// transcriber re-runs ema (x3 via MACD), kalman, holt, the articulation
// state machine and Wilder's RSI recurrence over its incremental trend
// window at every poll (engine/realtime.py, core/trend_fast.py).
//
// Python (ref/trend_ref.py) remains the SPEC and the oracle: every loop
// here mirrors the corresponding Python loop line by line, operating on the
// same float64 values with the same expression shapes.  The build passes
// -ffp-contract=off, so no a*b+c is contracted into an FMA on any host ISA,
// and without -ffast-math nothing is reassociated: each statement rounds
// exactly like the numpy scalar ops it mirrors and the outputs are
// BIT-IDENTICAL (tests/test_torch_realtime_copies.py holds them equal,
// buffer for buffer).  Reductions (np.mean seeds, window sums) stay in numpy
// on the Python side; only the recurrences live here, so no pairwise-sum
// replication is needed.
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC together with
// events_core.cpp (see aegis_tpu_torch/native/__init__.py; ctypes binding).

#include <cmath>

extern "C" {

// ref/trend_ref.py — EMA with NaN-gap reset.  alpha is computed by
// the caller (2/(span+1), one rounding, same as Python).
void aegis_trend_ema(const double* x, long n, double alpha, double* out) {
    const double nan = std::nan("");
    double prev = nan;
    bool started = false;
    for (long i = 0; i < n; ++i) {
        out[i] = nan;
        const double xi = x[i];
        if (std::isnan(xi)) {
            if (started) prev = nan;   // prev = nan if started else prev
            continue;
        }
        if (!started) {
            out[i] = xi;
            prev = xi;
            started = true;
        } else {
            out[i] = std::isnan(prev) ? xi
                                      : alpha * xi + (1.0 - alpha) * prev;
            prev = out[i];
        }
    }
}

// ref/trend_ref.py — scalar Kalman; NaN frames pass through
// without a state update.  The caller guarantees at least one valid
// sample and passes data[first] as the state seed (argmax(valid)).
void aegis_trend_kalman(const double* x, long n, double process_variance,
                        double measurement_variance, double x0,
                        double* out) {
    const double nan = std::nan("");
    double x_est = x0, p_est = 1.0;
    for (long i = 0; i < n; ++i) {
        out[i] = nan;
        const double xi = x[i];
        if (std::isnan(xi)) continue;
        const double p_pred = p_est + process_variance;
        const double k = p_pred / (p_pred + measurement_variance);
        x_est = x_est + k * (xi - x_est);
        p_est = (1.0 - k) * p_pred;
        out[i] = x_est;
    }
}

// ref/trend_ref.py — Holt level+trend smoothing.  The caller
// guarantees >= 2 valid samples and passes the two init values
// (data[fv[0]], data[fv[1]] - data[fv[0]], both plain copies/one
// subtraction done numpy-side).
void aegis_trend_holt(const double* x, long n, double alpha, double beta,
                      double level0, double trend0, double* out) {
    const double nan = std::nan("");
    double level = level0, trend = trend0;
    for (long i = 0; i < n; ++i) {
        out[i] = nan;
        const double xi = x[i];
        if (std::isnan(xi)) continue;
        const double forecast = level + trend;
        const double level_new = alpha * xi + (1.0 - alpha) * forecast;
        trend = beta * (level_new - level) + (1.0 - beta) * trend;
        level = level_new;
        out[i] = level;
    }
}

// ref/trend_ref.py — Bollinger-position articulation state machine.
// Codes: 0 none(NaN), 1 normal, 2 bend, 3 vibrato, 4 noise; state and
// counter skip NaN frames entirely (no prev_state update), exactly like
// the Python `continue`.
void aegis_trend_artic(const double* f0, const double* upper,
                       const double* lower, long n, signed char* out) {
    int prev_state = 0, counter = 0;
    for (long i = 0; i < n; ++i) {
        const double fi = f0[i];
        if (std::isnan(fi)) {
            out[i] = 0;                             // ARTIC_NONE
            continue;
        }
        int state = 0;
        if (!std::isnan(upper[i]) && fi > upper[i]) state = 1;
        else if (!std::isnan(lower[i]) && fi < lower[i]) state = 2;
        if (prev_state != state && prev_state != 0) counter += 1;
        else counter = 0;
        if (counter >= 2) out[i] = 3;               // ARTIC_VIBRATO
        else if (state == 1) out[i] = 2;            // ARTIC_BEND
        else if (state == 2) out[i] = 4;            // ARTIC_NOISE
        else out[i] = 1;                            // ARTIC_NORMAL
        prev_state = state;
    }
}

// ref/trend_ref.py on a FLOAT32 input — the live engine passes
// f0_clean.astype(float32) (engine/realtime.py::_analysis, matching the
// device trend program's dtype), and numpy's weak promotion then runs the
// whole state recurrence in float32: `k * (data[i] - x_est)` is
// python-float x np.float32 -> float32 (k cast down first), and the
// adds stay float32.  The k/p sequence itself is data-independent python
// doubles.  Mirrored op for op; the float64 out stores exact widenings.
void aegis_trend_kalman_f32(const float* x, long n, double process_variance,
                            double measurement_variance, float x0,
                            double* out) {
    const double nan = std::nan("");
    float x_est = x0;
    double p_est = 1.0;
    for (long i = 0; i < n; ++i) {
        out[i] = nan;
        const float xi = x[i];
        if (std::isnan(xi)) continue;
        const double p_pred = p_est + process_variance;
        const double k = p_pred / (p_pred + measurement_variance);
        x_est = x_est + static_cast<float>(k) * (xi - x_est);
        p_est = (1.0 - k) * p_pred;
        out[i] = static_cast<double>(x_est);
    }
}

// ref/trend_ref.py on a FLOAT32 input (same weak-promotion story:
// level/trend/forecast all stay float32; the python-double coefficients
// alpha, 1-alpha, beta, 1-beta are cast down at each multiply).
void aegis_trend_holt_f32(const float* x, long n, double alpha, double beta,
                          float level0, float trend0, double* out) {
    const double nan = std::nan("");
    const float af = static_cast<float>(alpha);
    const float omaf = static_cast<float>(1.0 - alpha);
    const float bf = static_cast<float>(beta);
    const float ombf = static_cast<float>(1.0 - beta);
    float level = level0, trend = trend0;
    for (long i = 0; i < n; ++i) {
        out[i] = nan;
        const float xi = x[i];
        if (std::isnan(xi)) continue;
        const float forecast = level + trend;
        const float level_new = af * xi + omaf * forecast;
        trend = bf * (level_new - level) + ombf * trend;
        level = level_new;
        out[i] = static_cast<double>(level);
    }
}

// ref/trend_ref.py — Wilder smoothing recurrence for RSI.  The
// caller computes the np.mean seeds (numpy pairwise sum — not replicated
// here) and passes gains/losses (len n-1, from np.diff); this fills
// avg_g/avg_l for i in [period+1, n).  Entries before that are the
// caller's (NaN + seeds at index `period`).
void aegis_trend_wilder(const double* gains, const double* losses, long n,
                        long period, double seed_g, double seed_l,
                        double* avg_g, double* avg_l) {
    const double pm1 = double(period - 1), p = double(period);
    double g = seed_g, l = seed_l;
    for (long i = period + 1; i < n; ++i) {
        g = (g * pm1 + gains[i - 1]) / p;
        l = (l * pm1 + losses[i - 1]) / p;
        avg_g[i] = g;
        avg_l[i] = l;
    }
}

}  // extern "C"
