// Native poly recovery-chain core — the C++ counterpart of the host-side
// envelope-physics passes in aegis_tpu_torch/core/poly.py (the raw-CQT recovery
// chain: rescue_dead_fundamentals, recover_octave_doublings,
// drop_leakage_ghosts, drop_straight_harmonic_ghosts) plus the shared
// envelope-statistics cache (_EnvCache: per-window per-bin medians and
// trimmed-line-fit shape statistics).
//
// Python (core/poly.py) remains the SPEC: every branch here mirrors the
// corresponding Python pass line by line (citations inline).  Decision
// parity on the truth corpora is asserted by tests/test_native_poly.py with
// AEGIS_NATIVE toggled; float near-parity notes:
//   * medians are BIT-IDENTICAL (exact k-selection; the even-length average
//     is computed in the plane's own dtype, matching numpy float32 rounding);
//   * line fits accumulate in double where numpy uses pairwise/BLAS sums —
//     agreement ~1e-6 relative, far inside every documented dB-scale margin;
//   * the outlier-trim argsort breaks residual ties by index (numpy's
//     introsort tie order is unspecified) — keep-set differences require
//     exact float ties at the cut boundary.
//
// Build: g++ -O3 -shared -fPIC together with events_core.cpp (see
// aegis_tpu_torch/native/__init__.py; ctypes binding, no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// config.midi_to_hz: 440 * 2**((m - 69) / 12); same libm pow as CPython.
inline double midi_to_hz(double m) {
    return 440.0 * std::pow(2.0, (m - 69.0) / 12.0);
}

// Python round() is half-to-even; nearbyint honors FE_TONEAREST (= same).
inline long round_half_even(double x) {
    return static_cast<long>(std::nearbyint(x));
}

// core/poly.py:578/587 — harmonics 2..8 above a fundamental, and the h3..h8
// subset (+12 handled separately).
const long HARM[7] = {12, 19, 24, 28, 31, 34, 36};
const long HIGH_HARM[6] = {19, 24, 28, 31, 34, 36};
const long RESCUE_OFFS[8] = {0, 12, 19, 24, 28, 31, 34, 36};

inline bool in_harm(long d) {
    for (long h : HARM) if (d == h) return true;
    return false;
}

// _HZ_TABLE (core/poly.py:583): midi 0..191 through the scalar midi_to_hz.
struct HzTable {
    double v[192];
    HzTable() { for (int m = 0; m < 192; ++m) v[m] = midi_to_hz(double(m)); }
};
const HzTable HZ;

// ---------------------------------------------------------------- line fits

// core/poly.py::_linefit — centered normal equations, a=0 when denom == 0.
inline void linefit(const double* t, const double* y, long n,
                    double* a, double* b) {
    if (n <= 0) { *a = 0.0; *b = NAN; return; }
    double tm = 0.0, ym = 0.0;
    for (long i = 0; i < n; ++i) { tm += t[i]; ym += y[i]; }
    tm /= n; ym /= n;
    double num = 0.0, den = 0.0;
    for (long i = 0; i < n; ++i) {
        double dt = t[i] - tm;
        num += dt * (y[i] - ym);
        den += dt * dt;
    }
    *a = den > 0.0 ? num / den : 0.0;
    *b = ym - (*a) * tm;
}

// core/poly.py::_env_shape — (trimmed linear-fit RMS residual [dB],
// |late slope - early slope| [dB/s]); trim_frac worst-residual frames are
// dropped and the fit redone on the keepers.
void env_shape(const double* env, long T, double fps,
               double* resid_out, double* curv_out,
               double trim_frac = 0.15) {
    if (T <= 0) { *resid_out = NAN; *curv_out = NAN; return; }
    thread_local std::vector<double> t, tk, yk;
    thread_local std::vector<std::pair<double, long>> order;
    t.resize(T);
    for (long i = 0; i < T; ++i) t[i] = double(i);
    double a, b;
    linefit(t.data(), env, T, &a, &b);
    long n_trim = static_cast<long>(T * trim_frac);
    if (n_trim > 0 && T - n_trim >= 4) {
        order.resize(T);
        for (long i = 0; i < T; ++i)
            order[i] = {std::fabs(env[i] - (a * t[i] + b)), i};
        // keep = ascending indices of the T-n_trim smallest residuals;
        // ties break by index (stable) — see the near-parity note on top
        std::sort(order.begin(), order.end());
        order.resize(T - n_trim);
        std::sort(order.begin(), order.end(),
                  [](const std::pair<double, long>& x,
                     const std::pair<double, long>& y_) {
                      return x.second < y_.second;
                  });
        tk.resize(order.size()); yk.resize(order.size());
        for (size_t i = 0; i < order.size(); ++i) {
            tk[i] = double(order[i].second);
            yk[i] = env[order[i].second];
        }
        linefit(tk.data(), yk.data(), (long)tk.size(), &a, &b);
    } else {
        tk = t;
        yk.assign(env, env + T);
    }
    const long nk = (long)tk.size();
    double ss = 0.0;
    for (long i = 0; i < nk; ++i) {
        double d = yk[i] - (a * tk[i] + b);
        ss += d * d;
    }
    *resid_out = std::sqrt(ss / nk);
    long h = nk / 2;
    double ae, be, al, bl;
    linefit(tk.data(), yk.data(), h, &ae, &be);
    linefit(tk.data() + h, yk.data() + h, nk - h, &al, &bl);
    *curv_out = std::fabs(al * fps - ae * fps);
}

// ------------------------------------------------------------ env cache

// _EnvCache (core/poly.py:757): memoized per-window envelope statistics
// over ONE dB plane.  The plane is stored in its source dtype so the
// even-length median average rounds exactly like numpy does.
struct EnvCache {
    // planes are stored TRANSPOSED (B x T) so every per-bin envelope slice
    // is contiguous — the med/shape gathers were stride-B reads otherwise
    std::vector<float> dbf;    // float32 plane (one of the two is used)
    std::vector<double> dbd;   // float64 plane
    bool is_f32;
    long T, B;
    double fps;
    std::unordered_map<uint64_t, std::vector<double>> med_rows;
    std::unordered_map<uint64_t, std::pair<double, double>> shapes;

    inline double at(long t, long b) const {
        return is_f32 ? double(dbf[b * T + t]) : dbd[b * T + t];
    }

    static inline uint64_t key2(long lo, long hi) {
        return (uint64_t(uint32_t(lo)) << 32) | uint64_t(uint32_t(hi));
    }
    static inline uint64_t key3(long lo, long hi, long b) {
        return (uint64_t(uint32_t(lo)) << 42) ^ (uint64_t(uint32_t(hi)) << 21)
             ^ uint64_t(uint32_t(b)) ^ (uint64_t(1) << 63);
    }

    // med_row: exact per-bin medians of db[lo:hi] (python slice clamping).
    const std::vector<double>& med_row(long lo, long hi) {
        uint64_t k = key2(lo, hi);
        auto it = med_rows.find(k);
        if (it != med_rows.end()) return it->second;
        long lo_c = std::min(std::max(lo, 0L), T);
        long hi_c = std::min(std::max(hi, 0L), T);
        long n = hi_c - lo_c;
        std::vector<double> row(B, NAN);
        if (n > 0) {
            long h = n / 2;
            if (is_f32) {
                std::vector<float> col(n);
                for (long b = 0; b < B; ++b) {
                    std::memcpy(col.data(), &dbf[b * T + lo_c],
                                sizeof(float) * n);
                    std::nth_element(col.begin(), col.begin() + h, col.end());
                    if (n % 2) {
                        row[b] = double(col[h]);
                    } else {
                        float hi_v = col[h];
                        float lo_v = *std::max_element(col.begin(),
                                                       col.begin() + h);
                        float s = lo_v + hi_v;   // float32 rounding, /2 exact
                        row[b] = double(s / 2.0f);
                    }
                }
            } else {
                std::vector<double> col(n);
                for (long b = 0; b < B; ++b) {
                    std::memcpy(col.data(), &dbd[b * T + lo_c],
                                sizeof(double) * n);
                    std::nth_element(col.begin(), col.begin() + h, col.end());
                    if (n % 2) {
                        row[b] = col[h];
                    } else {
                        double hi_v = col[h];
                        double lo_v = *std::max_element(col.begin(),
                                                        col.begin() + h);
                        row[b] = (lo_v + hi_v) / 2.0;
                    }
                }
            }
        }
        return med_rows.emplace(k, std::move(row)).first->second;
    }

    double med(long lo, long hi, long b) {
        if (b < 0) b += B;  // numpy negative-index semantics
        return med_row(lo, hi)[b];
    }

    std::pair<double, double> shape(long lo, long hi, long b) {
        if (b < 0) b += B;
        uint64_t k = key3(lo, hi, b);
        auto it = shapes.find(k);
        if (it != shapes.end()) return it->second;
        long lo_c = std::min(std::max(lo, 0L), T);
        long hi_c = std::min(std::max(hi, 0L), T);
        long n = hi_c - lo_c;
        double r, c;
        if (!is_f32 && n > 0) {
            env_shape(&dbd[b * T + lo_c], n, fps, &r, &c);
        } else {
            thread_local std::vector<double> env;
            env.resize(std::max(n, 0L));
            for (long t = 0; t < n; ++t) env[t] = at(lo_c + t, b);
            env_shape(env.data(), n, fps, &r, &c);
        }
        auto v = std::make_pair(r, c);
        shapes.emplace(k, v);
        return v;
    }
};

// ------------------------------------------------------------ shared scans

// core/poly.py::_overlap_rows — per-event ascending index lists of
// concurrent events (start[j] <= end[i] && start[i] <= end[j], j != i).
std::vector<std::vector<long>> overlap_rows(const long* start,
                                            const long* end_, long E) {
    std::vector<std::vector<long>> rows(E);
    for (long i = 0; i < E; ++i) {
        for (long j = 0; j < E; ++j) {
            if (j != i && start[j] <= end_[i] && start[i] <= end_[j])
                rows[i].push_back(j);
        }
    }
    return rows;
}

// core/poly.py::_foreign_line_near with the med_env/evidence_db form used by
// every native call site: med_env(note) = med(lo,hi, note-fmin), None (-> a
// blocking True) when the bin is out of range.
bool foreign_line_near(double pitch, const long* note,
                       const std::vector<long>& ev_idx,
                       const std::vector<long>& exclude_notes,
                       long parent_note,  // -1 = none
                       EnvCache* h, long lo, long hi, long fmin, long n_bins,
                       double evidence_db,
                       double tol_semis = 1.5, long hmax = 13,
                       double rim_tol_semis = 1.2,
                       double contrib_margin_db = 10.0) {
    double f_b = midi_to_hz(pitch);
    double f_p = parent_note >= 0 ? midi_to_hz(double(parent_note)) : 0.0;
    for (long j : ev_idx) {
        long on = note[j];
        bool excl = false;
        for (long x : exclude_notes) if (x == on) { excl = true; break; }
        if (excl) continue;
        double f_o = midi_to_hz(double(on));
        if (parent_note >= 0) {
            bool rim = false;
            for (long k = 2; k <= hmax; ++k) {
                if (std::fabs(12.0 * std::log2(f_o / (double(k) * f_p)))
                        <= rim_tol_semis) { rim = true; break; }
            }
            if (rim) continue;
        }
        for (long k = 2; k <= hmax; ++k) {
            double d = std::fabs(12.0 * std::log2(f_b / (double(k) * f_o)));
            if (d > tol_semis) continue;
            long line_bin = (double(k) * f_o < f_b)
                ? round_half_even(pitch - d) : round_half_even(pitch + d);
            long bb = line_bin - fmin;
            if (!(0 <= bb && bb < n_bins)) return true;  // med_env -> None
            double line_db = h->med(lo, hi, bb);
            double atten = 20.0 * std::log10(std::max(1.0 - d / 2.0, 0.05));
            if (line_db + atten >= evidence_db - contrib_margin_db)
                return true;
        }
    }
    return false;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------ env-cache API

void* aegis_env_new_f32(const float* db, long T, long B, double fps) {
    auto* h = new EnvCache();
    h->is_f32 = true;
    h->dbf.resize(T * B);
    for (long t = 0; t < T; ++t)
        for (long b = 0; b < B; ++b)
            h->dbf[b * T + t] = db[t * B + b];
    h->T = T; h->B = B; h->fps = fps;
    return h;
}

void* aegis_env_new_f64(const double* db, long T, long B, double fps) {
    auto* h = new EnvCache();
    h->is_f32 = false;
    h->dbd.resize(T * B);
    for (long t = 0; t < T; ++t)
        for (long b = 0; b < B; ++b)
            h->dbd[b * T + t] = db[t * B + b];
    h->T = T; h->B = B; h->fps = fps;
    return h;
}

void aegis_env_free(void* hp) { delete static_cast<EnvCache*>(hp); }

void aegis_env_med_row(void* hp, long lo, long hi, double* out) {
    auto* h = static_cast<EnvCache*>(hp);
    const std::vector<double>& row = h->med_row(lo, hi);
    std::memcpy(out, row.data(), sizeof(double) * h->B);
}

double aegis_env_med(void* hp, long lo, long hi, long b) {
    return static_cast<EnvCache*>(hp)->med(lo, hi, b);
}

void aegis_env_shape(void* hp, long lo, long hi, long b, double* out2) {
    auto v = static_cast<EnvCache*>(hp)->shape(lo, hi, b);
    out2[0] = v.first; out2[1] = v.second;
}

// -------------------------------------------------- rescue_dead_fundamentals

// Mirrors core/poly.py::rescue_dead_fundamentals:936-1060.  Returns the
// number of mints written as (src index, note, salience) triples, or
// -(needed) when cap is too small.
long aegis_poly_rescue(
    void* hp, long E,
    const long* note, const long* start, const long* end_, const double* sal,
    double binw, long fmin, long n_bins, double track_max_db,
    double live_floor_db, double max_resid, double max_curv,
    double max_slope, double leak_bins, double attack_skip_s, long min_frames,
    long cap, long* out_src, long* out_note, double* out_sal) {
    auto* h = static_cast<EnvCache*>(hp);
    const double fps = h->fps;
    auto rows = overlap_rows(start, end_, E);
    // note -> spans already minted at that pitch (per chord occurrence)
    std::unordered_map<long, std::vector<std::pair<long, long>>> minted;
    long m = 0;
    std::vector<long> group, lines, parents, voters;
    for (long i = 0; i < E; ++i) {
        group = rows[i];
        group.push_back(i);
        long lo = start[i] + long(attack_skip_s * fps);
        long hi = std::min(end_[i] - 1, h->T);
        if (hi - lo < min_frames) continue;
        // group spectral lines (fundamentals + harmonics), member-major
        lines.clear();
        for (long j : group)
            for (long off : RESCUE_OFFS) {
                long L = note[j] + off;
                if (L < 192) lines.push_back(L);
            }
        for (long h_int : HARM) {
            long f = note[i] - h_int;
            long bf = f - fmin;
            if (bf < 0) continue;
            bool dup = false;
            auto it = minted.find(f);
            if (it != minted.end()) {
                for (auto& sp : it->second)
                    if (sp.first <= end_[i] && start[i] <= sp.second) {
                        dup = true; break;
                    }
            }
            if (dup) continue;
            bool present = false;
            for (long j : group) if (note[j] == f) { present = true; break; }
            if (present) continue;
            double own = h->med(lo, hi, bf);
            if (own < track_max_db - live_floor_db) continue;
            auto rc = h->shape(lo, hi, bf);
            double r = rc.first, c = rc.second;
            // untrimmed slope gate (core/poly.py:981-985)
            long n_env = std::min(std::max(hi, 0L), h->T)
                       - std::min(std::max(lo, 0L), h->T);
            thread_local std::vector<double> env, taxis;
            env.resize(std::max(n_env, 0L));
            taxis.resize(env.size());
            for (long t = 0; t < n_env; ++t) env[t] = h->at(lo + t, bf);
            for (size_t t = 0; t < env.size(); ++t) taxis[t] = double(t);
            double a_s, b_s;
            linefit(taxis.data(), env.data(), (long)env.size(), &a_s, &b_s);
            double slope = a_s * fps;
            if (r > max_resid || c > max_curv || slope > max_slope) continue;
            // leakage guard over the group's lines (core/poly.py:997-1004)
            bool leaked = false;
            const std::vector<double>& mrow = h->med_row(lo, hi);
            for (long L : lines) {
                double d = std::fabs(HZ.v[f] - HZ.v[L]) / binw;
                long lb = L - fmin;
                if (0.3 < d && d <= leak_bins && 0 <= lb && lb < n_bins) {
                    double need = d <= 0.9 ? -2.0 : 1.0;
                    if (own <= mrow[lb] - need) { leaked = true; break; }
                }
            }
            if (leaked) continue;
            // parents: group members a harmonic interval BELOW f
            parents.clear();
            for (long j : group) if (in_harm(f - note[j])) parents.push_back(j);
            if (!parents.empty()) {
                bool all12 = true;
                for (long j : parents)
                    if (f - note[j] != 12) { all12 = false; break; }
                if (!all12) continue;
                bool beat = false;
                for (long up : {12L, 19L, 24L}) {
                    long b2 = f + up - fmin;
                    if (b2 >= n_bins) continue;
                    double ev_db = h->med(lo, hi, b2);
                    if (ev_db < track_max_db - live_floor_db) continue;
                    std::vector<long> excl = {f};
                    for (long j : parents) excl.push_back(note[j]);
                    if (foreign_line_near(double(f + up), note, group, excl,
                                          f - 12, h, lo, hi, fmin, n_bins,
                                          ev_db))
                        continue;
                    double r2 = h->shape(lo, hi, b2).first;
                    if (r2 >= std::max(0.25, 4.0 * r)) { beat = true; break; }
                }
                if (!beat) continue;
            }
            // voters: group members a harmonic interval ABOVE f
            voters.clear();
            for (long j : group) if (in_harm(note[j] - f)) voters.push_back(j);
            long src = -1;
            for (long j : voters) if (note[j] - f == 12) { src = j; break; }
            if (src < 0) {  // first max-salience voter (python max semantics)
                double best = -1e300;
                for (long j : voters)
                    if (sal[j] > best) { best = sal[j]; src = j; }
            }
            double vmax = -1e300;
            for (long j : voters) vmax = std::max(vmax, sal[j]);
            minted[f].push_back({start[src], end_[src]});
            if (m >= cap) return -(m + 1);
            out_src[m] = src; out_note[m] = f; out_sal[m] = vmax;
            ++m;
        }
    }
    return m;
}

// -------------------------------------------------- recover_octave_doublings

// Mirrors core/poly.py::recover_octave_doublings:1256-1406.  Mints are
// (parent index, salience) pairs; out_uncertain flags the parent events
// whose doubling is measurably unprovable.  Returns mint count or -(needed).
long aegis_poly_recover_octaves(
    void* hp, long E,
    const long* note, const long* start, const long* end_, const double* sal,
    const uint8_t* rescued_root,
    long fmin, long n_bins, double track_max_db, long sr,
    double resid_thr, double curv_thr, double rel_factor,
    double attack_skip_s, long min_frames, double level_floor_db,
    double parent_ghost_ratio, double feeder_floor_db,
    long cap, long* out_parent, double* out_sal, uint8_t* out_uncertain) {
    auto* h = static_cast<EnvCache*>(hp);
    const double fps = h->fps;
    auto rows = overlap_rows(start, end_, E);
    std::memset(out_uncertain, 0, E);
    long m = 0;
    for (long i = 0; i < E; ++i) {
        long n = note[i];
        long b0 = n - fmin, b12 = n + 12 - fmin;
        if (!(0 <= b0 && b0 < n_bins && b12 < n_bins)) continue;
        const std::vector<long>& idx = rows[i];
        bool has12 = false;
        for (long j : idx) if (note[j] == n + 12) { has12 = true; break; }
        if (has12) continue;
        double sal_i = sal[i];
        double cmax = sal_i;
        for (long j : idx) cmax = std::max(cmax, sal[j]);
        if (sal_i < parent_ghost_ratio * cmax && !rescued_root[i]) continue;
        // lower blocker, SIMULTANEOUS onsets only (|dstart| <= 4)
        bool blocked = false;
        for (long j : idx)
            if (note[j] < n && sal[j] >= 0.5 * sal_i &&
                std::labs(start[j] - start[i]) <= 4) { blocked = true; break; }
        if (blocked) continue;
        // harmonic collision: n+12 a harmonic interval above another voice
        bool coll = false;
        for (long j : idx)
            if (note[j] != n && in_harm(n + 12 - note[j])) {
                coll = true; break;
            }
        if (coll) continue;
        long lo = start[i] + long(attack_skip_s * fps);
        long hi = std::min(end_[i] - 1, h->T);
        if (hi - lo < min_frames) continue;
        // clip to the parent string's LIVE tail (core/poly.py:1313-1318)
        {
            long n_env = hi - lo;
            double mx = -1e300;
            for (long t = 0; t < n_env; ++t)
                mx = std::max(mx, h->at(lo + t, b0));
            long count = 0, last = -1;
            for (long t = 0; t < n_env; ++t)
                if (h->at(lo + t, b0) >= mx - 25.0) { ++count; last = t; }
            if (count >= min_frames) hi = lo + last + 1;
            if (hi - lo < min_frames) continue;
        }
        // feeder guard: live raw bin a high harmonic below n+12
        bool fed = false;
        const std::vector<double>& mrow = h->med_row(lo, hi);
        for (long u : HIGH_HARM) {
            long fb = n + 12 - u - fmin;
            if (0 <= fb && fb < n_bins &&
                mrow[fb] >= track_max_db - feeder_floor_db) {
                fed = true; break;
            }
        }
        if (fed) continue;
        if (h->med(lo, hi, b12) < track_max_db - level_floor_db) continue;
        auto rc0 = h->shape(lo, hi, b0);
        double r0 = rc0.first, c0 = rc0.second;
        auto beats_at = [&](long b, double floor_db) -> bool {
            if (h->med(lo, hi, b) < track_max_db - floor_db) return false;
            auto rc = h->shape(lo, hi, b);
            return rc.first >= std::max(resid_thr, rel_factor * r0)
                || rc.second >= std::max(curv_thr, rel_factor * c0);
        };
        bool beat = beats_at(b12, level_floor_db);
        bool aux_informative = false;
        if (!beat) {
            for (long up : {31L, 36L}) {
                long b = n + up - fmin;
                if (b >= n_bins) continue;
                double ev_db = h->med(lo, hi, b);
                std::vector<long> excl = {n};
                if (foreign_line_near(double(n + up), note, idx, excl, n,
                                      h, lo, hi, fmin, n_bins, ev_db))
                    continue;
                if (ev_db >= track_max_db - 40.0) aux_informative = true;
                if (beats_at(b, 40.0)) { beat = true; break; }
            }
        }
        if (beat) {
            double lvl = h->med(lo, hi, b12) - h->med(lo, hi, b0);
            double mult = std::min(std::pow(10.0, lvl / 20.0), 1.0);
            if (m >= cap) return -(m + 1);
            out_parent[m] = i; out_sal[m] = sal_i * mult; ++m;
        } else if (!aux_informative) {
            double r12 = h->shape(lo, hi, b12).first;
            double f12 = HZ.v[std::min(n + 12, 191L)];
            double beat_hz_bound = f12 * f12 / (2.0 * double(sr));
            double win_s = double(hi - lo) / fps;
            if (r12 < resid_thr && win_s * beat_hz_bound < 0.5)
                out_uncertain[i] = 1;
        }
    }
    return m;
}

// ------------------------------------------------------ drop_leakage_ghosts

// Mirrors core/poly.py::drop_leakage_ghosts:1096-1138.  out_keep[i]=0 drops.
void aegis_poly_drop_leakage(
    void* hp, long E,
    const long* note, const long* start, const long* end_,
    const uint8_t* exempt,
    double binw, long fmin, long n_bins,
    double leak_bins, double margin_db, double attack_skip_s, long min_frames,
    uint8_t* out_keep) {
    auto* h = static_cast<EnvCache*>(hp);
    const double fps = h->fps;
    auto rows = overlap_rows(start, end_, E);
    for (long i = 0; i < E; ++i) {
        out_keep[i] = 1;
        if (exempt[i]) continue;
        long be = note[i] - fmin;
        long lo = start[i] + long(attack_skip_s * fps);
        long hi = std::min(end_[i] - 1, h->T);
        if (!(0 <= be && be < n_bins) || hi - lo < min_frames) continue;
        double own = h->med(lo, hi, be);
        double f_e = HZ.v[note[i]];
        for (long j : rows[i]) {
            if (note[j] == note[i]) continue;
            long cb = note[j] - fmin;
            if (!(0 <= cb && cb < n_bins)) continue;
            double d = std::fabs(f_e - HZ.v[note[j]]) / binw;
            if (d > leak_bins) continue;
            double need = std::max(1.0, margin_db * (d - 0.5) / 1.5);
            if (own <= h->med_row(lo, hi)[cb] - need) {
                out_keep[i] = 0;
                break;
            }
        }
    }
}

// ---------------------------------------------- drop_straight_harmonic_ghosts

// Mirrors core/poly.py::drop_straight_harmonic_ghosts:1665-1771.
// line_harmonics (length n_line) selects the frequency-line parent mode;
// n_line == 0 means interval mode over `intervals`.  sal_guard < 0 disables
// the guard (python None).  out_keep[i]=0 drops.
void aegis_poly_drop_straight(
    void* hp, long E,
    const long* note, const long* start, const long* end_, const double* sal,
    const uint8_t* rescued_root,
    long fmin, long n_bins, double track_max_db,
    const long* intervals, long n_intervals,
    double resid_thr, double curv_thr, double rel_factor,
    double attack_skip_s, long min_frames,
    double sal_guard,
    const long* line_harmonics, long n_line, double line_tol_semis,
    long beat_scan, double beat_floor_db,
    uint8_t* out_keep) {
    auto* h = static_cast<EnvCache*>(hp);
    const double fps = h->fps;
    auto rows = overlap_rows(start, end_, E);
    std::vector<long> parents;
    for (long i = 0; i < E; ++i) {
        out_keep[i] = 1;
        long n = note[i];
        long b0 = n - fmin;
        if (!(0 <= b0 && b0 < n_bins)) continue;
        if (rescued_root[i]) continue;
        parents.clear();
        if (n_line > 0) {
            double f_n = midi_to_hz(double(n));
            for (long j : rows[i]) {
                if (note[j] >= n) continue;
                double f_o = HZ.v[note[j]];
                for (long k = 0; k < n_line; ++k) {
                    double d = std::fabs(12.0 * std::log2(
                        f_n / (double(line_harmonics[k]) * f_o)));
                    if (d <= line_tol_semis) { parents.push_back(j); break; }
                }
            }
        } else {
            for (long j : rows[i]) {
                long d = n - note[j];
                for (long k = 0; k < n_intervals; ++k)
                    if (intervals[k] == d) { parents.push_back(j); break; }
            }
        }
        if (parents.empty()) continue;
        if (sal_guard >= 0.0) {
            double pmax = -1e300;
            for (long j : parents) pmax = std::max(pmax, sal[j]);
            if (sal[i] >= sal_guard * pmax) continue;
        }
        long lo = start[i] + long(attack_skip_s * fps);
        long hi = std::min(end_[i] - 1, h->T);
        if (hi - lo < min_frames) continue;
        auto rc = h->shape(lo, hi, b0);
        double r = rc.first, c = rc.second;
        long p = parents[0];
        for (long j : parents) if (note[j] < note[p]) p = j;
        long bp = note[p] - fmin;
        auto rcp = h->shape(lo, hi, bp);
        double rp = rcp.first, cp = rcp.second;
        if (r < std::max(resid_thr, rel_factor * rp) &&
            c < std::max(curv_thr, rel_factor * cp)) {
            if (beat_scan) {
                bool kept = false;
                for (long up : {12L, 19L, 24L}) {
                    long b = n + up - fmin;
                    if (b >= n_bins) continue;
                    double ev_db = h->med(lo, hi, b);
                    if (ev_db < track_max_db - beat_floor_db) continue;
                    std::vector<long> excl = {n, note[p]};
                    if (foreign_line_near(double(n + up), note, rows[i], excl,
                                          note[p], h, lo, hi, fmin, n_bins,
                                          ev_db))
                        continue;
                    auto rcb = h->shape(lo, hi, b);
                    if (rcb.first >= std::max(resid_thr, rel_factor * rp) ||
                        rcb.second >= std::max(curv_thr, rel_factor * cp)) {
                        kept = true;
                        break;
                    }
                }
                if (kept) continue;
            }
            out_keep[i] = 0;
        }
    }
}

// --------------------------------------------------------- snap_starts_poly

// Mirrors core/poly.py::snap_starts_poly's sorted-onsets path.  Events
// arrive in (note, start)-sorted order (the Python wrapper sorts); writes
// the snapped start per event.  rms comes in its source dtype so the
// diff/argmax arithmetic rounds exactly like numpy (is_f32 selects).
void aegis_poly_snap_starts(
    long E, const long* note, const long* start, const long* end_,
    const long* onsets, long n_on,
    const void* rms, long T_rms, long is_f32,
    long back_frames, long* out_start) {
    const float* rf = static_cast<const float*>(rms);
    const double* rd = static_cast<const double*>(rms);
    std::unordered_map<long, long> prev_end;
    for (long i = 0; i < E; ++i) {
        long s = start[i];
        out_start[i] = s;
        auto it = prev_end.find(note[i]);
        long pe = it == prev_end.end() ? -1 : it->second;
        long lo = std::max(std::max(s - back_frames, pe + 1), 0L);
        // searchsorted(onsets, s, "right") - 1
        long j = long(std::upper_bound(onsets, onsets + n_on, s) - onsets) - 1;
        if (j >= 0 && onsets[j] >= lo) {
            long o = onsets[j];
            // seg = rms[o : s+1]; numpy slice clamps to [0, T)
            long a = std::min(std::max(o, 0L), T_rms);
            long b = std::min(std::max(s + 1, 0L), T_rms);
            long n_seg = b - a;
            if (n_seg >= 2) {
                // argmax of diff(seg) — first max, dtype-faithful
                long best_k = 0;
                if (is_f32) {
                    float best = rf[a + 1] - rf[a];
                    for (long k = 1; k < n_seg - 1; ++k) {
                        float d = rf[a + k + 1] - rf[a + k];
                        if (d > best) { best = d; best_k = k; }
                    }
                } else {
                    double best = rd[a + 1] - rd[a];
                    for (long k = 1; k < n_seg - 1; ++k) {
                        double d = rd[a + k + 1] - rd[a + k];
                        if (d > best) { best = d; best_k = k; }
                    }
                }
                long ns = o + best_k + 1;
                if (ns < s) out_start[i] = ns;
            }
        }
        prev_end[note[i]] = end_[i];
    }
}

// -------------------------------------------------------------- decay_prune

// Mirrors core/poly.py::decay_prune.  sorted_idx maps start-sorted
// positions back to original event indices (the `o is not e` identity
// test); onsets arrive sorted.  total_frames < 0 means python None.
void aegis_poly_decay_prune(
    long E, const long* start, const long* end_,
    const long* sorted_idx, const long* sorted_starts,
    const long* onsets, long n_on,
    double frac, long total_frames, long concurrent_tol,
    uint8_t* out_keep) {
    for (long i = 0; i < E; ++i) {
        out_keep[i] = 1;
        long k = long(std::upper_bound(onsets, onsets + n_on, start[i])
                      - onsets) - 1;
        if (k < 0) continue;
        long gap_end = (k + 1 < n_on) ? onsets[k + 1]
            : (total_frames >= 0 ? total_frames : end_[i] + 1);
        long gap = std::max(gap_end - onsets[k], 1L);
        if (double(end_[i] - start[i] + 1) >= frac * gap) continue;
        long lo = long(std::lower_bound(sorted_starts, sorted_starts + E,
                                        start[i] - concurrent_tol)
                       - sorted_starts);
        long hi = long(std::upper_bound(sorted_starts, sorted_starts + E,
                                        start[i] + concurrent_tol)
                       - sorted_starts);
        bool sustained = false;
        for (long p = lo; p < hi; ++p) {
            long j = sorted_idx[p];
            if (j != i &&
                double(end_[j] - start[j] + 1) >= 0.7 * gap) {
                sustained = true;
                break;
            }
        }
        if (sustained) out_keep[i] = 0;
    }
}

// ---------------------------------------------------------- attach_salience

// numpy's pairwise float32 sum (scalar spec: n<8 naive, n<=128 8-accumulator
// unrolled, else recursive halving with the split rounded down to a multiple
// of 8) — verified bit-identical to np.float32 .sum() on this box.
static float pairwise_sum_f32(const float* a, long n) {
    if (n < 8) {
        float s = 0.0f;
        for (long i = 0; i < n; ++i) s += a[i];
        return s;
    }
    if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        long i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3]))
                  + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    long n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum_f32(a, n2) + pairwise_sum_f32(a + n2, n - n2);
}

// Mirrors core/poly.py::attach_salience: per-event mean of the float32
// salience plane (B x T transposed input, contiguous per-note slices).
// mean = pairwise_sum / n in float32, widened — matching seg.mean().
void aegis_poly_attach_salience(
    long E, const long* note, const long* start, const long* end_,
    const float* sal_T, long T, long n_notes,
    double* out_sal) {
    for (long i = 0; i < E; ++i) {
        long b = note[i];
        if (b < 0) b += n_notes;  // numpy negative-index semantics
        long a = std::min(std::max(start[i], 0L), T);
        long z = std::min(std::max(end_[i] + 1, 0L), T);
        long n = z - a;
        if (n <= 0 || b < 0 || b >= n_notes) { out_sal[i] = 0.0; continue; }
        float s = pairwise_sum_f32(&sal_T[b * T + a], n);
        out_sal[i] = double(s / float(n));
    }
}

// ----------------------------------------------------------- harmonic_dedup

// Mirrors core/poly.py::harmonic_dedup's pair sweep.  out_keep[i]=0 drops
// (rescued_root events are exempt regardless of domination).
void aegis_poly_harmonic_dedup(
    long E, const long* note, const long* start, const long* end_,
    const double* sal, const uint8_t* rescued_root,
    double sal_ratio, long start_tol,
    uint8_t* out_keep) {
    for (long i = 0; i < E; ++i) {
        out_keep[i] = 1;
        if (rescued_root[i]) continue;
        for (long j = 0; j < E; ++j) {
            if (j == i) continue;
            if (!in_harm(note[i] - note[j])) continue;
            if (!(start[j] - start_tol <= start[i] && start[i] <= end_[j]))
                continue;
            if (sal[i] < sal_ratio * sal[j]) { out_keep[i] = 0; break; }
        }
    }
}

// -------------------------------------------------- repitch_suboctave_ghosts

// Mirrors core/poly.py::repitch_suboctave_ghosts.  out_action per event:
// 0 = keep, 1 = drop (dead + margin but the +12 note already exists),
// 2 = re-pitch one octave up (tag repitched_octave).
void aegis_poly_repitch(
    void* hp, long E,
    const long* note, const long* start, const long* end_,
    const uint8_t* rescued_root,
    double binw, long fmin, long n_bins, double track_max_db,
    double margin_db, double abs_floor_db, double attack_skip_s,
    long min_frames, double leak_bins, double leak_margin_db,
    uint8_t* out_action) {
    auto* h = static_cast<EnvCache*>(hp);
    const double fps = h->fps;
    auto rows = overlap_rows(start, end_, E);
    for (long i = 0; i < E; ++i) {
        out_action[i] = 0;
        long n = note[i];
        long b0 = n - fmin, b12 = n + 12 - fmin;
        if (!(0 <= b0 && b0 < n_bins && b12 < n_bins)) continue;
        if (rescued_root[i]) continue;
        bool lower = false;
        for (long j : rows[i]) if (note[j] < n) { lower = true; break; }
        if (lower) continue;
        long lo = start[i] + long(attack_skip_s * fps);
        long hi = std::min(end_[i] - 1, h->T);
        if (hi - lo < min_frames) continue;
        double own = h->med(lo, hi, b0);
        double up = h->med(lo, hi, b12);
        double f_n = HZ.v[n];
        bool leak_dead = false;
        for (long j : rows[i]) {
            long on = note[j];
            if (on == n) continue;
            long ob = on - fmin;
            if (!(0 <= ob && ob < n_bins)) continue;
            if (std::fabs(f_n - HZ.v[on]) > leak_bins * binw) continue;
            if (own <= h->med(lo, hi, ob) - leak_margin_db) {
                leak_dead = true;
                break;
            }
        }
        bool dead = own < track_max_db - abs_floor_db || leak_dead;
        if (dead && up - own >= margin_db) {
            bool dup = false;
            for (long j : rows[i])
                if (note[j] == n + 12) { dup = true; break; }
            out_action[i] = dup ? 1 : 2;
        }
    }
}

// ----------------------------------------------------- recover_missing_fifths

// Mirrors core/poly.py::recover_missing_fifths, including the appended-tail
// walk (recovered fifths join later events' guards).  Mints are
// (parent index, salience) pairs; returns the count or -(needed).
long aegis_poly_recover_fifths(
    void* hp, long E,
    const long* note, const long* start, const long* end_, const double* sal,
    long fmin, long n_bins, double track_max_db,
    double level_floor_db, double rel_parent_db, double max_resid,
    double attack_skip_s, long min_frames,
    long cap, long* out_parent, double* out_sal) {
    auto* h = static_cast<EnvCache*>(hp);
    const double fps = h->fps;
    auto rows = overlap_rows(start, end_, E);
    struct Mint { long note, start, end; double sal; };
    std::vector<Mint> appended;
    long m = 0;
    std::vector<long> c_note, c_start;
    std::vector<double> c_sal;
    for (long i = 0; i < E; ++i) {
        long n = note[i];
        long b0 = n - fmin, b7 = n + 7 - fmin;
        if (!(0 <= b0 && b0 < n_bins && b7 < n_bins)) continue;
        // concurrent = base rows + overlapping appended fifths (that order)
        c_note.clear(); c_sal.clear();
        for (long j : rows[i]) {
            c_note.push_back(note[j]);
            c_sal.push_back(sal[j]);
        }
        for (auto& a : appended)
            if (a.start <= end_[i] && start[i] <= a.end) {
                c_note.push_back(a.note);
                c_sal.push_back(a.sal);
            }
        bool rim = false;
        for (long cn : c_note)
            if (std::labs(cn - (n + 7)) <= 2) { rim = true; break; }
        if (rim) continue;
        double sal_i = sal[i];
        double pmax = sal_i;
        for (double cs : c_sal) pmax = std::max(pmax, cs);
        if (sal_i < 0.5 * pmax) continue;
        bool blocked = false;
        for (size_t k = 0; k < c_note.size(); ++k)
            if (c_note[k] < n && c_sal[k] >= 0.5 * sal_i) {
                blocked = true;
                break;
            }
        if (blocked) continue;
        bool coll = false;
        for (long cn : c_note) {
            for (long hh : HARM)
                if (std::labs((cn + hh) - (n + 7)) <= 2) { coll = true; break; }
            if (coll) break;
        }
        if (coll) continue;
        long lo = start[i] + long(attack_skip_s * fps);
        long hi = std::min(end_[i] - 1, h->T);
        if (hi - lo < min_frames) continue;
        double med7 = h->med(lo, hi, b7);
        if (med7 < track_max_db - level_floor_db) continue;
        if (med7 < h->med(lo, hi, b0) - rel_parent_db) continue;
        // untrimmed fit + RMS residual over env7 (core/poly.py:1709-1713)
        long lo_c = std::min(std::max(lo, 0L), h->T);
        long hi_c = std::min(std::max(hi, 0L), h->T);
        long Tn = hi_c - lo_c;
        thread_local std::vector<double> env, taxis;
        env.resize(std::max(Tn, 0L));
        taxis.resize(std::max(Tn, 0L));
        for (long t = 0; t < Tn; ++t) {
            env[t] = h->at(lo_c + t, b7);
            taxis[t] = double(t);
        }
        double a_f, b_f;
        linefit(taxis.data(), env.data(), Tn, &a_f, &b_f);
        double ss = 0.0;
        for (long t = 0; t < Tn; ++t) {
            double d = env[t] - (a_f * taxis[t] + b_f);
            ss += d * d;
        }
        double resid = std::sqrt(ss / Tn);
        if (resid > max_resid || a_f * fps > 0.0) continue;
        double lvl = med7 - h->med(lo, hi, b0);
        double new_sal = sal_i * std::min(std::pow(10.0, lvl / 20.0), 1.0);
        appended.push_back({n + 7, start[i], end_[i], new_sal});
        if (m >= cap) return -(m + 1);
        out_parent[m] = i; out_sal[m] = new_sal; ++m;
    }
    return m;
}

// ------------------------------------------------------- roll run extraction

// Mirrors core/poly.py::roll_to_events's run scan: note-major nonzero runs
// with the gap-merge rule, min-duration filter, and per-run confidence max
// over the full [s, e] span.  Returns run count or -(needed).
long aegis_poly_roll_runs(
    const uint8_t* roll, const float* conf, long T, long n_notes,
    long min_frames, long gap_frames,
    long cap, long* out_s, long* out_e, long* out_note, double* out_conf) {
    long m = 0;
    for (long b = 0; b < n_notes; ++b) {
        long run_s = -1, prev = -1;
        auto flush = [&](long s, long e) {
            if (e - s + 1 < min_frames) return;
            float cmax = conf[s * n_notes + b];
            for (long t = s + 1; t <= e; ++t)
                cmax = std::max(cmax, conf[t * n_notes + b]);
            if (m < cap) {
                out_s[m] = s; out_e[m] = e; out_note[m] = b;
                out_conf[m] = double(cmax);
            }
            ++m;
        };
        for (long t = 0; t < T; ++t) {
            if (!roll[t * n_notes + b]) continue;
            if (run_s < 0) {
                run_s = t;
            } else if (t - prev > gap_frames + 1) {
                flush(run_s, prev);
                run_s = t;
            }
            prev = t;
        }
        if (run_s >= 0) flush(run_s, prev);
    }
    return m > cap ? -m : m;
}

// ------------------------------------------- drop_composite_harmonic_ghosts

// Mirrors core/poly.py::drop_composite_harmonic_ghosts.
void aegis_poly_drop_composite(
    long E, const long* note, const long* start, const long* end_,
    const double* sal,
    const long* line_harmonics, long n_line,
    double sal_guard, double line_tol_semis,
    uint8_t* out_keep) {
    auto rows = overlap_rows(start, end_, E);
    std::vector<long> pm_notes;
    for (long i = 0; i < E; ++i) {
        out_keep[i] = 1;
        double f_e = midi_to_hz(double(note[i]));
        pm_notes.clear();
        for (long j : rows[i]) {
            if (note[j] >= note[i]) continue;
            double f_o = (note[j] >= 0 && note[j] < 192)
                ? HZ.v[note[j]] : midi_to_hz(double(note[j]));
            for (long k = 0; k < n_line; ++k) {
                double d = std::fabs(12.0 * std::log2(
                    f_e / (double(line_harmonics[k]) * f_o)));
                if (d <= line_tol_semis) { pm_notes.push_back(note[j]); break; }
            }
        }
        // distinct parent-note count
        std::vector<long> uniq(pm_notes);
        std::sort(uniq.begin(), uniq.end());
        uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
        if (uniq.size() < 2) continue;
        // psal: max salience over concurrents whose note matches ANY parent
        double psal = -1e300;
        for (long j : rows[i]) {
            bool match = false;
            for (long pn : uniq) if (note[j] == pn) { match = true; break; }
            if (match) psal = std::max(psal, sal[j]);
        }
        if (sal[i] < sal_guard * psal) out_keep[i] = 0;
    }
}

}  // extern "C"
