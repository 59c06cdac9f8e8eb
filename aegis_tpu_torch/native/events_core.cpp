// Native event-segmentation core — the C++ counterpart of the reference's
// midi_logic.py runtime layer (frame rows -> note events).
//
// Semantics mirror aegis_tpu_torch/core/events.py EXACTLY (which mirrors reference
// midi_logic.py:32-146 with the documented fixes); a parity test
// (tests/test_torch_engine.py) asserts identical event lists against the
// NumPy implementation.  The per-frame scan, per-segment articulation
// least-squares, min-duration filter and sustain merge all run here; the
// per-event passes that need Python objects (onset re-split, hammer/pull
// tagging) stay in Python where event counts are tiny.
//
// Build: g++ -O3 -shared -fPIC (see aegis_tpu_torch/native/__init__.py; loaded via
// ctypes).

#include <cfenv>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double hz_to_midi(double hz) {
    return 12.0 * std::log2(hz / 440.0) + 69.0;
}

// numpy's np.round is round-half-even; std::nearbyint honors the current
// rounding mode, which defaults to FE_TONEAREST (= half-even).
inline long round_half_even(double x) {
    return static_cast<long>(std::nearbyint(x));
}

// least-squares line fit over the finite, positive samples of
// f0_smooth[start..end] in MIDI space; returns technique code + slope
// (mirror of detect_articulations_v1)
void articulation(const double* f0, long start, long end,
                  long* tech, double* slope_out) {
    *tech = 0;
    *slope_out = 0.0;
    if (end <= start) return;
    // gather valid samples
    std::vector<double> y;
    y.reserve(end - start + 1);
    for (long t = start; t <= end; ++t) {
        double v = f0[t];
        if (std::isfinite(v) && v > 0.0) y.push_back(hz_to_midi(v));
    }
    const long n = static_cast<long>(y.size());
    if (n < 3) return;
    double xm = (n - 1) / 2.0, ym = 0.0;
    for (long i = 0; i < n; ++i) ym += y[i];
    ym /= n;
    double sxy = 0.0, sxx = 0.0;
    for (long i = 0; i < n; ++i) {
        sxy += (i - xm) * (y[i] - ym);
        sxx += (i - xm) * (i - xm);
    }
    double slope = sxx > 0.0 ? sxy / sxx : 0.0;
    double icpt = ym - slope * xm;
    double dmin = 1e300, dmax = -1e300;
    for (long i = 0; i < n; ++i) {
        double d = y[i] - (slope * i + icpt);
        if (d < dmin) dmin = d;
        if (d > dmax) dmax = d;
    }
    double vib_amp = dmax - dmin;
    if (vib_amp > 0.3) { *tech = 1; *slope_out = slope; return; }   // vibrato
    if (slope > 0.05)  { *tech = 2; *slope_out = slope; return; }   // bend
    if (std::fabs(slope) > 0.02) { *tech = 3; *slope_out = slope; return; }  // slide
}

}  // namespace

extern "C" {

// Returns the number of events written, or -(required capacity) when cap is
// too small (caller retries with a larger buffer).
long aegis_segment_v1(
    const double* f0_smooth,       // (T,) 0 on unvoiced (already nan_to_num)
    const uint8_t* voiced,         // (T,)
    const double* probs,           // (T,)
    const double* rms_db,          // (T,)
    const uint8_t* rake,           // (T,)
    long T,
    double conf_threshold,
    double noise_gate_db,
    long min_frames,
    long sustain_frames,
    long cap,
    long* out_start, long* out_end, long* out_note, long* out_vel,
    long* out_track,               // 1 = main, 0 = safe
    long* out_tech, double* out_conf, double* out_rms, double* out_slope) {
    // pass 1: segment the active mask into constant-note runs, apply the
    // articulation + min-duration passes inline
    long n = 0;
    long seg_start = -1;
    long seg_note = -1;
    long overflow_needed = 0;

    auto flush = [&](long s, long e, long note) {
        if (e - s < min_frames) return;  // min-duration filter
        if (n >= cap) { ++overflow_needed; return; }
        out_start[n] = s;
        out_end[n] = e;
        out_note[n] = note;
        double c = probs[s];
        out_conf[n] = c;
        double vel = (rms_db[s] + 80.0) * 1.5;
        if (vel < 0.0) vel = 0.0;
        if (vel > 127.0) vel = 127.0;
        out_vel[n] = static_cast<long>(vel);  // matches .astype(int64) trunc
        out_track[n] = c >= conf_threshold ? 1 : 0;
        out_rms[n] = rms_db[s];
        articulation(f0_smooth, s, e, &out_tech[n], &out_slope[n]);
        ++n;
    };

    for (long t = 0; t < T; ++t) {
        bool act = voiced[t] && rms_db[t] >= noise_gate_db &&
                   f0_smooth[t] > 0.0 && !rake[t];
        long note = -1;
        if (act) {
            double f = f0_smooth[t] > 1e-6 ? f0_smooth[t] : 1e-6;
            note = round_half_even(hz_to_midi(f));
        }
        if (act && note == seg_note && seg_start >= 0) continue;
        if (seg_start >= 0) flush(seg_start, t - 1, seg_note);
        seg_start = act ? t : -1;
        seg_note = act ? note : -1;
    }
    if (seg_start >= 0) flush(seg_start, T - 1, seg_note);
    if (overflow_needed > 0) return -(n + overflow_needed);

    // pass 2: sustain merge (same-note events across short gaps; no merge
    // across a technique on the EARLIER event)
    if (n < 2) return n;
    long w = 0;
    for (long r = 1; r < n; ++r) {
        long gap = out_start[r] - out_end[w];
        if (out_note[r] == out_note[w] && gap <= sustain_frames &&
            out_tech[w] == 0) {
            out_end[w] = out_end[r];
        } else {
            ++w;
            if (w != r) {
                out_start[w] = out_start[r]; out_end[w] = out_end[r];
                out_note[w] = out_note[r]; out_vel[w] = out_vel[r];
                out_track[w] = out_track[r]; out_tech[w] = out_tech[r];
                out_conf[w] = out_conf[r]; out_rms[w] = out_rms[r];
                out_slope[w] = out_slope[r];
            }
        }
    }
    return w + 1;
}

}  // extern "C"
