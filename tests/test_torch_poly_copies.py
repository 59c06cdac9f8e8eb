"""The host half of the port's polyphonic stack is a copy: every copied
function and every ``poly_*_native`` wrapper is held equal to its original in
``aegis_tpu`` on the JAX engine's own analyses, with the C++ library on and
off (the pattern of tests/test_native_poly.py), the envelope medians bit for
bit in float32 and float64, and the tab / fret / MusicXML modules on the same
events.
"""

import copy
import importlib

import numpy as np
import pytest

import aegis_tpu.native as jnative
import aegis_tpu_torch.native as tnative
from aegis_tpu.core import poly as jpoly
from aegis_tpu.core.analyze import reflect_head as j_reflect_head
from aegis_tpu.core.cqt import pick_onsets, split_events_at_onsets
from aegis_tpu.engine.poly import AegisPolyEngine as JaxPolyEngine
from aegis_tpu.ref import poly_ref as jref
from aegis_tpu.ref.dsp_ref import amplitude_to_db
from aegis_tpu.tools.signal_gen import generate_chord_progression

from aegis_tpu_torch.core import poly as tpoly
from aegis_tpu_torch.core.analyze import reflect_head
from aegis_tpu_torch.engine.poly import AegisPolyEngine
from aegis_tpu_torch.ref import poly_ref as tref

HAVE_LIB = tnative.get_lib() is not None and jnative.get_lib() is not None

# (name, sr, seed, prog): two standard progressions, the 44.1 kHz window, and
# the octave-family voicings that exercise rescue + octave recovery + the +12
# straightness pass with beat scan
OCTAVES = [([40, 47, 52], 0.9), ([45, 52, 57], 0.8), ([52, 64], 0.8),
           ([48, 60], 0.8)]
CLIPS = {"seed1": (22050, 1, None), "seed7": (22050, 7, None),
         "seed7_44k": (44100, 7, None), "octaves": (22050, 5, OCTAVES)}


@pytest.fixture(scope="module")
def analyses():
    cache = {}

    def get(name):
        if name not in cache:
            sr, seed, prog = CLIPS[name]
            kw = {"prog": prog} if prog else {}
            y, _ = generate_chord_progression(seed, sr, **kw)
            eng = JaxPolyEngine(sample_rate=sr)
            a = eng.analyze(y)
            a["cqt_mag"] = np.asarray(a["cqt_mag"])
            cache[name] = (sr, eng, a)
        return cache[name]
    return get


def force_python(monkeypatch):
    """Both packages report their library unavailable (pure-Python paths)."""
    for nat in (jnative, tnative):
        monkeypatch.setattr(nat, "_TRIED", True)
        monkeypatch.setattr(nat, "_LIB", None)


def set_native(native, monkeypatch):
    if native:
        if not HAVE_LIB:
            pytest.skip("no C++ compiler: the NumPy paths are the only ones")
    else:
        force_python(monkeypatch)


# ------------------------------------------------- the chain, stage by stage

def _stages(sr, hop, n_fft, a, onsets, rms_db):
    """The steps of refine_poly_events, each a function of (module, events,
    that module's (dB plane, envelope cache))."""
    fps = sr / hop
    mag, T = a["cqt_mag"], a["roll"].shape[0]
    kw = dict(n_fft=n_fft)
    return [
        ("attach_salience",
         lambda P, ev, c: P.attach_salience(ev, np.asarray(a["salience"]))),
        ("snap_starts_poly",
         lambda P, ev, c: P.snap_starts_poly(ev, onsets, rms_db,
                                             back_frames=int(0.2 * fps))),
        ("decay_prune",
         lambda P, ev, c: P.decay_prune(ev, onsets, frac=0.5,
                                        total_frames=T)),
        ("onset_birth_gate",
         lambda P, ev, c: P.onset_birth_gate(ev, onsets,
                                             tol_frames=int(0.08 * fps))),
        ("attack_rise_gate",
         lambda P, ev, c: P.attack_rise_gate(ev, rms_db, win_frames=4,
                                             min_rise_db=2.0)),
        ("rescue_dead_fundamentals",
         lambda P, ev, c: P.rescue_dead_fundamentals(
             ev, mag, sr, hop, db=c[0], cache=c[1], **kw)),
        ("harmonic_dedup", lambda P, ev, c: P.harmonic_dedup(ev)),
        ("repitch_suboctave_ghosts",
         lambda P, ev, c: P.repitch_suboctave_ghosts(
             ev, mag, sr, hop, db=c[0], cache=c[1], **kw)),
        ("drop_leakage_ghosts",
         lambda P, ev, c: P.drop_leakage_ghosts(
             ev, mag, sr, hop, db=c[0], cache=c[1], **kw)),
        ("recover_octave_doublings",
         lambda P, ev, c: P.recover_octave_doublings(
             ev, mag, sr, hop, db=c[0], cache=c[1])),
        ("recover_missing_fifths",
         lambda P, ev, c: P.recover_missing_fifths(
             ev, mag, sr, hop, db=c[0], cache=c[1])),
        ("drop_straight_harmonic_ghosts",
         lambda P, ev, c: P.drop_straight_harmonic_ghosts(
             ev, mag, sr, hop, line_harmonics=tuple(range(3, 11)),
             db=c[0], cache=c[1])),
        ("drop_composite_harmonic_ghosts",
         lambda P, ev, c: P.drop_composite_harmonic_ghosts(ev)),
        ("drop_straight_harmonic_ghosts_octave",
         lambda P, ev, c: P.drop_straight_harmonic_ghosts(
             ev, mag, sr, hop, intervals=frozenset((12,)), sal_guard=1.0,
             beat_scan=True, db=c[0], cache=c[1])),
        ("drop_leakage_ghosts_again",
         lambda P, ev, c: P.drop_leakage_ghosts(
             ev, mag, sr, hop, db=c[0], cache=c[1], **kw)),
    ]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_every_stage_equals_its_original(name, native, analyses, monkeypatch):
    """Each copied pass, fed the original chain's events at that point,
    returns the original's events dict for dict."""
    set_native(native, monkeypatch)
    sr, eng, a = analyses(name)
    hop, n_fft = eng.hop_length, eng.n_fft
    rms_db = amplitude_to_db(np.asarray(a["rms"]))
    rolls = [P.silence_gate(a["roll"], rms_db) for P in (tpoly, jpoly)]
    np.testing.assert_array_equal(*rolls)
    evs = [P.roll_to_events(rolls[0], a["confidence"], a["rms"], sr, hop,
                            sustain_ms=120.0, rms_db=rms_db)
           for P in (tpoly, jpoly)]
    assert evs[0] == evs[1] and evs[0]
    onsets = pick_onsets(a["onset_env"], sr, hop)
    ev = split_events_at_onsets(evs[1], onsets, min_frames=2)
    onsets = np.unique(np.concatenate([[0], onsets]))
    caches = {}
    for P in (tpoly, jpoly):
        dbp = P._dbp(a["cqt_mag"])
        caches[P] = (dbp, P._EnvCache(dbp, sr / hop))
        assert (caches[P][1]._nh is not None) == native
    np.testing.assert_array_equal(caches[tpoly][0], caches[jpoly][0])
    changed = 0
    for stage, step in _stages(sr, hop, n_fft, a, onsets, rms_db):
        want = step(jpoly, copy.deepcopy(ev), caches[jpoly])
        got = step(tpoly, copy.deepcopy(ev), caches[tpoly])
        assert got == want, stage
        changed += want != ev
        ev = want
    assert ev and changed >= 3
    # the composed chain, and the chords grouped from its events
    args = (split_events_at_onsets(evs[1], pick_onsets(a["onset_env"], sr,
                                                       hop), min_frames=2),
            pick_onsets(a["onset_env"], sr, hop), rms_db, a["salience"],
            sr, hop)
    kw = dict(total_frames=a["roll"].shape[0], cqt_mag=a["cqt_mag"],
              n_fft=n_fft)
    want = jpoly.refine_poly_events(copy.deepcopy(args[0]), *args[1:], **kw)
    got = tpoly.refine_poly_events(copy.deepcopy(args[0]), *args[1:], **kw)
    assert got == want == ev
    assert tpoly.group_chords(got, sr, hop) == jpoly.group_chords(want, sr,
                                                                  hop)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_native_chain_equals_python_chain(name, analyses, monkeypatch):
    """The port's extraction with its C++ library equals the same extraction
    without it, and both equal the JAX package's, flags included."""
    if not HAVE_LIB:
        pytest.skip("no C++ compiler")
    sr, jeng, a = analyses(name)
    eng = AegisPolyEngine(sample_rate=sr, device="cpu")
    ev_nat = eng.extract_events(a)
    assert ev_nat == jeng.extract_events(a)
    force_python(monkeypatch)
    ev_py = eng.extract_events(a)
    assert ev_py == ev_nat and ev_py == jeng.extract_events(a)
    for k in ("octave_uncertain", "recovered_octave", "rescued_root"):
        assert [bool(e.get(k)) for e in ev_nat] == \
            [bool(e.get(k)) for e in ev_py]


def test_the_port_builds_a_library_of_its_own():
    if not HAVE_LIB:
        pytest.skip("no C++ compiler")
    import os
    assert any(s.endswith("poly_recover.cpp") for s in tnative._SRCS)
    assert tnative._cache_dir() != jnative._cache_dir()
    with open(os.path.join(os.path.dirname(tnative.__file__),
                           "poly_recover.cpp")) as f, \
            open(os.path.join(os.path.dirname(jnative.__file__),
                              "poly_recover.cpp")) as g:
        ours = [ln for ln in f if not ln.startswith("//")]
        theirs = [ln for ln in g if not ln.startswith("//")]
    assert ours == theirs


# --------------------------------------------------------- envelope statistics

def _np_median_rows(win):
    n = win.shape[0]
    if n == 0:
        return np.full(win.shape[1], np.nan)
    if n % 2:
        return np.partition(win, n // 2, axis=0)[n // 2]
    p = np.partition(win, (n // 2 - 1, n // 2), axis=0)
    return (p[n // 2 - 1] + p[n // 2]) / 2.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_env_medians_bit_for_bit(dtype, monkeypatch):
    rng = np.random.default_rng(0)
    db = rng.normal(-30, 15, (200, 84)).astype(dtype)
    windows = [(0, 200), (3, 40), (17, 18), (50, 83), (10, 10), (5, 4),
               (4, 77)]
    if HAVE_LIB:
        h_t, h_j = tnative.EnvHandle(db, 43.066), jnative.EnvHandle(db, 43.066)
        for lo, hi in windows:
            got = h_t.med_row(lo, hi)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got, _np_median_rows(db[lo:hi]))
            np.testing.assert_array_equal(got, h_j.med_row(lo, hi))
        for lo, hi, b in ((0, 200, 3), (3, 40, 80), (50, 83, 0)):
            assert h_t.shape(lo, hi, b) == pytest.approx(
                h_j.shape(lo, hi, b), rel=1e-9, abs=1e-12)
        # a negative bin wraps as NumPy indexing does
        assert h_t.shape(0, 50, -2) == h_t.shape(0, 50, 82)
        assert h_t.med_row(0, 50)[-2 + 84] == pytest.approx(
            tpoly._med(db[:50, -2].copy()), abs=1e-6)
        nat = tpoly._EnvCache(db, 43.066)
        assert nat._nh is not None
    force_python(monkeypatch)
    c_t, c_j = tpoly._EnvCache(db, 43.066), jpoly._EnvCache(db, 43.066)
    assert c_t._nh is None and c_j._nh is None
    for lo, hi in windows:
        np.testing.assert_array_equal(c_t.med_row(lo, hi),
                                      _np_median_rows(db[lo:hi]))
        np.testing.assert_array_equal(c_t.med_row(lo, hi),
                                      c_j.med_row(lo, hi))
        if HAVE_LIB:
            np.testing.assert_array_equal(c_t.med_row(lo, hi),
                                          nat.med_row(lo, hi))
    assert c_t.med(3, 40, 7) == c_j.med(3, 40, 7)
    assert c_t.shape(3, 40, 7) == c_j.shape(3, 40, 7)


def test_env_shape_and_small_helpers_equal_the_originals():
    rng = np.random.default_rng(2)
    fps = 43.066
    for trial in range(20):
        T = int(rng.integers(6, 120))
        t = np.arange(T)
        env = (-20.0 - 0.4 * t + 3.0 * np.sin(0.3 * t + trial)
               + rng.normal(0, 0.3, T)).astype(np.float32)
        assert tpoly._env_shape(env, fps) == jpoly._env_shape(env, fps)
        assert tpoly._med(env.copy()) == jpoly._med(env.copy())
        assert tpoly._linefit(t.astype(np.float64), env.astype(np.float64)) \
            == jpoly._linefit(t.astype(np.float64), env.astype(np.float64))
        if HAVE_LIB:
            db = np.tile(env[:, None], (1, 4))
            r_c, c_c = tnative.EnvHandle(db, fps).shape(0, T, 1)
            r_py, c_py = tpoly._env_shape(db[:, 1], fps)
            assert r_c == pytest.approx(r_py, rel=1e-4, abs=1e-6)
            assert c_c == pytest.approx(c_py, rel=1e-4, abs=1e-5)
    mag = (rng.random((30, 84)) ** 4).astype(np.float32)
    np.testing.assert_array_equal(tpoly._dbp(mag), jpoly._dbp(mag))
    for sr in (22050, 44100, 48000):
        assert tpoly._default_n_fft(sr) == jpoly._default_n_fft(sr)
    assert tpoly.HARMONIC_INTERVALS == jpoly.HARMONIC_INTERVALS
    assert tpoly.HIGH_HARMONIC_INTERVALS == jpoly.HIGH_HARMONIC_INTERVALS
    np.testing.assert_array_equal(tpoly._HZ_TABLE, jpoly._HZ_TABLE)
    ev = [{"note": 40 + 3 * k, "start": 5 * k, "end": 5 * k + 12}
          for k in range(9)]
    for a, b in zip(tpoly._overlap_rows(ev, chunk=4),
                    jpoly._overlap_rows(ev, chunk=4)):
        np.testing.assert_array_equal(a, b)


def test_native_pass_preconditions():
    if not HAVE_LIB:
        pytest.skip("no C++ compiler")
    cache = tpoly._EnvCache(np.zeros((40, 84), np.float32), 43.0)
    assert cache._nh is not None
    ev = [{"note": 60, "start": 0, "end": 30}]
    assert tpoly._native_pass_ok(ev, 24, 84, cache)
    assert not tpoly._native_pass_ok([{"note": 120, "start": 0, "end": 3}],
                                     24, 84, cache)
    assert not tpoly._native_pass_ok([{"note": 10, "start": 0, "end": 3}],
                                     24, 84, cache)
    assert not tpoly._native_pass_ok(ev, 24, 80, cache)
    assert not tpoly._native_pass_ok([], 24, 84, cache)


# --------------------------------------------------- wrappers, one at a time

@pytest.mark.parametrize("name", ["seed7", "octaves"])
def test_roll_runs_and_salience_wrappers(name, analyses):
    """poly_roll_runs_native and poly_attach_salience_native of the port
    against the original's and the NumPy paths."""
    if not HAVE_LIB:
        pytest.skip("no C++ compiler")
    sr, eng, a = analyses(name)
    roll_u8 = np.ascontiguousarray(np.asarray(a["roll"], bool).view(np.uint8))
    conf = np.ascontiguousarray(a["confidence"], np.float32)
    got = tnative.poly_roll_runs_native(roll_u8, conf, 2, 5)
    want = jnative.poly_roll_runs_native(roll_u8, conf, 2, 5)
    assert len(got[0]) > 0
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    events = eng.extract_events(a, use_onsets=False)
    sal_T = np.ascontiguousarray(np.asarray(a["salience"]).T)
    np.testing.assert_array_equal(
        tnative.poly_attach_salience_native(events, sal_T),
        jnative.poly_attach_salience_native(events, sal_T))


# ---------------------------------------------------------------- the oracle

@pytest.mark.parametrize("seed", [0, 1])
def test_poly_ref_equals_its_original(seed):
    rng = np.random.default_rng(seed)
    cqt = (rng.random((40, 84)) ** 3).astype(np.float32)
    supp = tref.harmonic_suppression_matrix(84)
    sub = tref.harmonic_subtraction_matrix(84)
    for x, y in zip(tref.peel_voices_ref(cqt, supp, sub),
                    jref.peel_voices_ref(cqt, supp, sub)):
        np.testing.assert_array_equal(x, y)
    bins, sals = tref.peel_voices_ref(cqt, supp)
    for gp in (None, 3.0):
        for x, y in zip(tref.roll_and_confidence_ref(bins, sals,
                                                     global_peak=gp),
                        jref.roll_and_confidence_ref(bins, sals,
                                                     global_peak=gp)):
            np.testing.assert_array_equal(x, y)


def test_reflect_head_equals_its_original():
    rng = np.random.default_rng(3)
    x = rng.integers(-3000, 3000, (2, 5000)).astype(np.int16)
    for ctx, half, true_len in ((5120, 1024, None), (5120, 1024, 700),
                                (1024, 1024, None), (10, 4, 1), (10, 4, 0)):
        np.testing.assert_array_equal(
            reflect_head(x, ctx, half, true_len=true_len),
            j_reflect_head(x, ctx, half, true_len=true_len))
    y = x[0].astype(np.float32)
    np.testing.assert_array_equal(reflect_head(y, 2048, 1024),
                                  j_reflect_head(y, 2048, 1024))
    np.testing.assert_array_equal(reflect_head(y, 2048, 1024)[-3:],
                                  y[3:0:-1])


# ------------------------------------------------------ tabs, frets, MusicXML

def _modules(name):
    return (importlib.import_module(f"aegis_tpu_torch.midi.{name}"),
            importlib.import_module(f"aegis_tpu.midi.{name}"))


@pytest.mark.parametrize("name", ["seed1", "octaves"])
def test_tabs_fret_filter_and_musicxml_equal_the_originals(name, analyses,
                                                           tmp_path):
    sr, eng, a = analyses(name)
    events = eng.extract_events(a)
    hop = eng.hop_length
    t, j = _modules("tabs")
    assert t.STANDARD_TUNING == j.STANDARD_TUNING
    for pitch in (28, 40, 52, 64, 76, 100):
        assert t.fret_candidates(pitch) == j.fret_candidates(pitch)
    tabs_t = t.generate_tabs_chords(copy.deepcopy(events), sr, hop)
    tabs_j = j.generate_tabs_chords(copy.deepcopy(events), sr, hop)
    assert tabs_t == tabs_j and tabs_t
    assert t.generate_tabs(copy.deepcopy(events)) == \
        j.generate_tabs(copy.deepcopy(events))
    drop_d = [36, 45, 50, 55, 59, 64]
    assert t.generate_tabs(copy.deepcopy(events), tuning=drop_d) == \
        j.generate_tabs(copy.deepcopy(events), tuning=drop_d)
    for width in (72, 40):
        assert t.render_ascii_tab(tabs_t, width) == \
            j.render_ascii_tab(tabs_j, width)
    assert t.render_ascii_tab([]) == j.render_ascii_tab([])
    t, j = _modules("fret_filter")
    for note in (40, 52, 64, 88):
        assert t.midi_to_fret_positions(note) == j.midi_to_fret_positions(note)
    assert t.min_fret_distance(t.midi_to_fret_positions(40),
                               t.midi_to_fret_positions(64)) == \
        j.min_fret_distance(j.midi_to_fret_positions(40),
                            j.midi_to_fret_positions(64))
    # a melodic line with an unplayable leap in it
    line = [dict(e, start=10 * k, end=10 * k + 8)
            for k, e in enumerate(events[:6])]
    line[2]["note"], line[3]["note"] = 40, 88
    got = t.apply_fret_filter(copy.deepcopy(line), sr, hop)
    want = j.apply_fret_filter(copy.deepcopy(line), sr, hop)
    assert got == want
    t, j = _modules("musicxml")
    pa = t.export_musicxml(tabs_t, str(tmp_path / "t.xml"))
    pb = j.export_musicxml(tabs_j, str(tmp_path / "j.xml"))
    with open(pa, "rb") as f, open(pb, "rb") as g:
        data = f.read()
        assert data == g.read() and b"score-partwise" in data
