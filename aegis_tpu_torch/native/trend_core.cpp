// Native Wilder recurrence of the RSI ghost-note filter: the C++
// counterpart of the sequential Python loop in ref/trend_ref.py::rsi, and
// a copy of aegis_trend_wilder from aegis_tpu/native/trend_core.cpp (the
// other recurrences of that file serve the live engine, which this package
// does not have yet).
//
// Python (ref/trend_ref.py) remains the spec: the loop here mirrors the
// Python loop line by line on the same float64 values with the same
// expression shapes.  x86-64 g++ without -march/-ffast-math neither
// contracts a*b+c into FMA nor reassociates FP, so each statement rounds
// exactly like the numpy scalar ops it mirrors and the outputs are
// bit-identical (tests/test_torch_engine.py holds them equal).  The np.mean
// seeds stay in numpy on the Python side.
//
// Build: g++ -O3 -shared -fPIC together with events_core.cpp (see
// aegis_tpu_torch/native/__init__.py; ctypes binding).

extern "C" {

// ref/trend_ref.py::rsi — Wilder smoothing recurrence.  The caller
// computes the np.mean seeds and passes gains/losses (len n-1, from
// np.diff); this fills avg_g/avg_l for i in [period+1, n).  Entries before
// that are the caller's (NaN + seeds at index `period`).
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
