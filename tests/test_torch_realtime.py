"""aegis_tpu_torch live transcribers (v1, financial and polyphonic) on the
CPU: against the JAX package's ``StreamingTranscriber`` and
``StreamingPolyTranscriber`` fed the same chunks, against the port's own
tiled and fused engines, and the finalized-event horizon
(``poll_events() == _poll_full()`` at every poll).

The port runs with ``device="cpu"``, where the Viterbi wrappers take their
plain versions.  Tolerances against the JAX rows, per tile block:

  * ``f0``, ``voiced_flag``, ``rake_mask``, ``mute_mask``: equal;
  * ``voiced_probs``, ``rms``: 1e-6 (sums in another order than XLA's);
  * ``onset_env``: 2e-3, the tolerance tests/test_torch_turbo.py holds the
    tiled ``mel_db`` to per bin (it is a mean over bins of dB differences);
  * ``dist_high_sum`` / ``dist_total_sum``: 2e-3 a summed bin (39 / 128).

Events: every discrete field equal, floats within 1e-5.

Live poly, per tile block: voice bins equal, saliences rtol 5e-4 / atol 1e-4,
``rms`` 1e-6, ``onset_env`` 2e-3, the f16 CQT plane within one f16 step.
"""

import numpy as np
import pytest
import torch

from aegis_tpu.config import AudioConfig as JAudioConfig
from aegis_tpu.engine.realtime import StreamingPolyTranscriber as JaxPolyStreaming
from aegis_tpu.engine.realtime import StreamingTranscriber as JaxStreaming
from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.core.events import extract_events_v1
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.engine.realtime import (StreamingPolyTranscriber,
                                             StreamingTranscriber)
from aegis_tpu_torch.core.poly import unpack_cqt_f16
from aegis_tpu_torch.engine.poly import AegisPolyEngine
from aegis_tpu_torch.engine.turbo import run_analyze_turbo
from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                              generate_chord_progression,
                                              generate_test_track,
                                              karplus_strong)
from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

# One torch thread per process: the suite runs in parallel pytest workers.
torch.set_num_threads(1)

SR = 22050
AUDIO = AudioConfig(sample_rate=SR)
ROW_ATOL = {"voiced_probs": 1e-6, "rms": 1e-6, "onset_env": 2e-3,
            "dist_high_sum": 2e-3 * 39, "dist_total_sum": 2e-3 * 128}


def _norm(y):
    return (y / max(np.max(np.abs(y)), 1e-9) * 0.8).astype(np.float32)


def _loud_first_clip():
    """Loudest attack first, so the running dB reference equals the global
    one from tile 0 (the causal-vs-offline difference vanishes)."""
    rng = np.random.default_rng(3)
    return _norm(np.concatenate([
        karplus_strong(110.0, 0.8, SR, rng=rng),            # loud A2
        0.5 * karplus_strong(146.83, 0.7, SR, rng=rng),     # D3
        0.4 * karplus_strong(196.0, 0.7, SR, rng=rng)]))    # G3


def _louder_midway_clip():
    """The Karplus-Strong test track, then a louder attack: the causal
    reference moves mid-stream."""
    y, _ = generate_test_track(sr=SR)
    rng = np.random.default_rng(4)
    return _norm(np.concatenate(
        [0.4 * y / np.max(np.abs(y)),
         karplus_strong(146.83, 0.9, SR, rng=rng)]))


CLIPS = {"loud_first": _loud_first_clip, "louder_midway": _louder_midway_clip}


def _feed_randomly(rts, y, seed=0, poll_at=None):
    """Feed every transcriber the same random chunk sizes (tiny ones too);
    returns each one's mid-stream poll taken at sample ``poll_at``."""
    rng = np.random.default_rng(seed)
    pos, polls = 0, None
    while pos < len(y):
        n = int(rng.integers(100, 9000))
        for rt in rts:
            rt.feed(y[pos: pos + n])
        pos += n
        if poll_at is not None and polls is None and pos >= poll_at:
            polls = [rt.poll_events() for rt in rts]
    return polls


def assert_same_events(got, ref, tol=1e-5):
    assert len(got) == len(ref), (len(got), len(ref))
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= tol, (k, g, r)
            else:
                assert g[k] == r[k], (k, g, r)


# ------------------------------------------------------ against the JAX package

@pytest.mark.parametrize("financial", [False, True], ids=["v1", "financial"])
@pytest.mark.parametrize("tile,halo", [(16, 8), (24, 8)])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_live_rows_and_events_match_jax(clip, tile, halo, financial):
    y = CLIPS[clip]()
    kw = {} if financial else {"confidence_threshold": 0.5}
    jx = JaxStreaming(audio=JAudioConfig(sample_rate=SR), tile_frames=tile,
                      halo_frames=halo, financial=financial, **kw)
    pt = StreamingTranscriber(audio=AUDIO, tile_frames=tile,
                              halo_frames=halo, financial=financial,
                              device="cpu", **kw)
    poll_j, poll_t = _feed_randomly([jx, pt], y, poll_at=int(0.7 * len(y)))
    assert len(pt._rows) == len(jx._rows) >= 3
    for b, (got, ref) in enumerate(zip(pt._rows, jx._rows)):
        assert got.shape == ref.shape == (tile, len(pt._rows_spec))
        assert got.dtype == ref.dtype == np.float32
        for i, k in enumerate(pt._rows_spec):
            if k in ROW_ATOL:
                np.testing.assert_allclose(got[:, i], ref[:, i], rtol=0,
                                           atol=ROW_ATOL[k], err_msg=f"{k} {b}")
            else:
                np.testing.assert_array_equal(got[:, i], ref[:, i],
                                              err_msg=f"{k} tile {b}")
    assert poll_j
    assert_same_events(poll_t, poll_j)
    final_j = jx.finalize()
    assert final_j
    assert_same_events(pt.finalize(), final_j)
    assert pt.lookahead_s == jx.lookahead_s
    assert pt.frames_analyzed == jx.frames_analyzed


@pytest.mark.parametrize("sr", [44100])
def test_live_rows_match_jax_at_44100(sr):
    """The server's default rate (w = 51): rows of a short clip."""
    y, _ = generate_test_track(sr=sr)
    y = y[: 2 * sr]
    jx = JaxStreaming(audio=JAudioConfig(sample_rate=sr), financial=True)
    pt = StreamingTranscriber(audio=AudioConfig(sample_rate=sr),
                              financial=True, device="cpu")
    _feed_randomly([jx, pt], y, seed=1)
    jx.finalize(), pt.finalize()
    got, ref = np.concatenate(pt._rows), np.concatenate(jx._rows)
    assert got.shape == ref.shape and len(pt._rows) >= 7
    for i, k in enumerate(pt._rows_spec):
        if k in ROW_ATOL:
            np.testing.assert_allclose(got[:, i], ref[:, i], rtol=0,
                                       atol=ROW_ATOL[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[:, i], ref[:, i], err_msg=k)


# ------------------------------------------------------ the port against itself

def test_streaming_matches_turbo_events():
    y = _loud_first_clip()
    tile, halo = 16, 8
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=tile, halo_frames=halo,
                              confidence_threshold=0.5, device="cpu")
    _feed_randomly([rt], y)
    live = rt.poll_events()  # callable mid-stream
    got = rt.finalize()
    assert got, "no events from the stream"
    assert len(live) <= len(got) + 1

    tr = run_analyze_turbo(y, AUDIO, PyinConfig(),
                           turbo=TurboConfig(tile_frames=tile,
                                             halo_frames=halo), device="cpu")
    ref = extract_events_v1(
        rake_mask=tr["rake_mask"], f0=np.nan_to_num(tr["f0"]),
        voiced_flag=tr["voiced_flag"], active_probs=tr["voiced_probs"],
        rms=tr["rms"], sr=SR, hop_length=512, confidence_threshold=0.5,
        onset_env=tr["onset_env"])
    m = note_event_f1(events_to_seconds(ref, SR, 512),
                      events_to_seconds(got, SR, 512))
    assert m["f1"] == 1.0, (m, ref, got)
    # past the loudest attack the live rows ARE the tiled program's
    T = len(tr["f0"])
    rows = rt._final_rows
    np.testing.assert_array_equal(rows["voiced_flag"][:T], tr["voiced_flag"])
    np.testing.assert_array_equal(np.nan_to_num(rows["f0"][:T]),
                                  np.nan_to_num(tr["f0"]))


def test_streaming_financial_matches_offline():
    y = _loud_first_clip()
    eng = AegisFinancialEngine(sample_rate=SR, device="cpu")
    offline, _ = eng.extract_events(eng.analyze(y))
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              financial=True, device="cpu")
    assert rt.poll_events() == []
    _feed_randomly([rt], y)
    live = rt.poll_events()
    got = rt.finalize()
    assert got and live
    m = note_event_f1(events_to_seconds(offline, SR, 512),
                      events_to_seconds(got, SR, 512))
    assert m["f1"] >= 0.99, (m, offline, got)


@pytest.mark.parametrize("financial", [False, True], ids=["v1", "financial"])
def test_chunking_invariance(financial):
    """One feed of the whole clip and many small ones give identical rows."""
    y = _louder_midway_clip()[: 3 * SR]
    one = StreamingTranscriber(audio=AUDIO, financial=financial, device="cpu")
    many = StreamingTranscriber(audio=AUDIO, financial=financial, device="cpu")
    assert one.feed(y) == len(one._rows) > 0
    _feed_randomly([many], y, seed=7)
    assert len(many._rows) == len(one._rows)
    for a, b in zip(one._rows, many._rows):
        assert a.tobytes() == b.tobytes()
    assert one.finalize() == many.finalize()


def test_streaming_lookahead_and_empty():
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              device="cpu")
    assert 0 < rt.lookahead_s < 2.0
    assert rt.frames_analyzed == 0
    assert rt.poll_events() == []
    assert rt.finalize() == []
    # silence stream: analyzes tiles, emits nothing
    for financial in (False, True):
        rt2 = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                                   financial=financial, device="cpu")
        rt2.feed(np.zeros(SR, np.float32))
        assert rt2.frames_analyzed > 0
        assert rt2.poll_events() == []
        assert rt2.finalize() == []


def test_streaming_incremental_tiles():
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              device="cpu")
    tile_samp = 16 * 512
    ctx = rt._ctx
    assert ctx == 8 * 512 + 1024
    # not enough for the first tile's right halo yet (the left one is the
    # synthetic silence the stream starts with)
    assert rt.feed(np.zeros(tile_samp, np.float32)) == 0
    assert rt.feed(np.zeros(ctx - 1, np.float32)) == 0
    # completing the halo releases exactly one tile
    assert rt.feed(np.zeros(1, np.float32)) == 1
    assert rt.frames_analyzed == 16
    # and each further tile's worth of samples one more
    assert rt.feed(np.zeros(2 * tile_samp, np.float32)) == 2


def test_finalize_is_terminal_and_idempotent():
    y = _loud_first_clip()
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              confidence_threshold=0.5, device="cpu")
    rt.feed(y)
    final = rt.finalize()
    assert final
    assert rt.finalize() == final
    assert rt.poll_events() == final
    # rows are cut to the true frame count: the silence pad is not audio
    assert len(rt._final_rows["f0"]) == AUDIO.n_frames(len(y))
    assert rt._n_fed == len(y)
    with pytest.raises(RuntimeError):
        rt.feed(np.zeros(1000, np.float32))


def _float_scale_program(audio, pyin_cfg, turbo, financial):
    """The live tile program as it ran before its body took the dequant
    scale and the rake sensitivity as 0-d tensors: both Python floats, the
    same ops."""
    from aegis_tpu_torch.core.analyze import _GTR_ROWS, _V1_ROWS
    from aegis_tpu_torch.core.tables import tables_from_numpy
    from aegis_tpu_torch.engine.turbo import _tile_analyze, _tile_mel_power

    tile, halo = turbo.tile_frames, turbo.halo_frames
    tables = tables_from_numpy(audio, pyin_cfg, torch.device("cpu"))

    def program(slab16, scale, rake_sens, ref_power):
        slab = (slab16.to(torch.float32) * scale)[None]
        mel_power = _tile_mel_power(slab, audio, pyin_cfg, turbo, tables)
        interior_max = torch.amax(mel_power[:, halo: halo + tile])
        new_ref = torch.maximum(ref_power, interior_max)
        mel_db = 10.0 * torch.log10(torch.clamp_min(mel_power, 1e-10))
        mel_db = mel_db - 10.0 * torch.log10(torch.clamp_min(new_ref, 1e-10))
        mel_db = torch.clamp_min(mel_db, -80.0)
        out = _tile_analyze(slab, mel_db, rake_sens, audio, pyin_cfg, turbo,
                            tables, financial=financial)
        cols = [out[k][0].to(torch.float32)[:, None]
                for k in (_GTR_ROWS if financial else _V1_ROWS)]
        return torch.cat(cols, dim=1), new_ref

    return program


def _session_against_float_program(y, sr, financial, rake=0.6):
    """A session fed ``y`` a tile at a time, every tile's rows and running
    reference held bitwise to the float-scale program's on the same slabs:
    the session's rows."""
    from aegis_tpu_torch.core.analyze import quantize_pcm16

    audio = AudioConfig(sample_rate=sr)
    rt = StreamingTranscriber(audio=audio, financial=financial,
                              rake_sensitivity=rake, device="cpu")
    ref_program = _float_scale_program(audio, rt.pyin_cfg, rt.turbo,
                                       financial)
    ts, ctx = rt._tile_samp, rt._ctx
    padded = np.concatenate([np.zeros(ctx, np.float32), y])
    ref = torch.zeros((), dtype=torch.float32)
    n_tiles = (len(y) - ts - ctx) // ts
    assert rt.feed(y[: ts + ctx]) == 1
    for k in range(n_tiles):
        if k:
            assert rt.feed(y[ts + ctx + (k - 1) * ts: ts + ctx + k * ts]) == 1
        slab16, scale = quantize_pcm16(padded[k * ts: k * ts + 2 * ctx + ts])
        rows, ref = ref_program(torch.from_numpy(slab16),
                                float(np.float32(scale)), rake, ref)
        assert rt._rows[k].tobytes() == rows.numpy().tobytes(), k
        assert rt._ref_power.numpy().tobytes() == ref.numpy().tobytes(), k
    assert n_tiles >= 15 and float(ref) > 0
    return np.concatenate(rt._rows)


@pytest.mark.parametrize("sr", [22050, 44100])
@pytest.mark.parametrize("financial", [False, True], ids=["v1", "financial"])
def test_tile_body_with_a_tensor_scale_equals_the_float_scale_program(
        financial, sr):
    """A 20 s session fed a tile at a time: every tile's rows and running
    reference bitwise those of the program that took the scale as a
    float, run on the same slabs."""
    _session_against_float_program(generate_bench_track(20.0, sr=sr), sr,
                                   financial)


def test_tile_body_with_a_tensor_rake_equals_the_float_rake_program():
    """The rake sensitivity enters the body as a 0-d float32 tensor: at
    0.3, at 0.9 and at a value that a float32 rounds onto a mel share (64 / 128),
    a 10 s session's rows bitwise those of the program that took the rake
    as a float; the rake masks of 0.3 and 0.9 differ, so the value is
    read, not fixed."""
    from aegis_tpu_torch.core.analyze import _V1_ROWS

    y = generate_bench_track(10.0, sr=22050)
    rows = {rake: _session_against_float_program(y, 22050, False, rake)
            for rake in (0.3, 0.9, 0.4999999999)}
    col = _V1_ROWS.index("rake_mask")
    assert (rows[0.3][:, col] != rows[0.9][:, col]).any()


def test_tile_program_keeps_its_signature_and_cache():
    """One program per (config, device), built once; the body takes the
    scale and the rake as 0-d tensors, the call the slab and scale as the
    ingest stages them and the rake as a float."""
    import inspect

    from aegis_tpu_torch.engine import realtime

    assert list(inspect.signature(realtime._tile_program).parameters) == [
        "audio", "pyin_cfg", "turbo", "financial", "use_guitar_filters",
        "device"]
    args = (AUDIO, PyinConfig(), TurboConfig(tile_frames=24, halo_frames=8),
            False, True, torch.device("cpu"))
    program = realtime._tile_program(*args)
    assert realtime._tile_program(*args) is program
    assert realtime._tile_program.cache_info().maxsize == 8
    span = 2 * (8 * 512 + 1024) + 24 * 512
    slab16 = torch.zeros(span, dtype=torch.int16)
    zero = torch.zeros((), dtype=torch.float32)
    rows, new_ref = program(slab16, zero, 0.6, zero)
    body_rows, body_ref = program.body(slab16, zero, torch.tensor(0.6), zero)
    assert rows.shape == (24, len(program.rows_spec))
    assert rows.numpy().tobytes() == body_rows.numpy().tobytes()
    assert new_ref.numpy().tobytes() == body_ref.numpy().tobytes()
    assert program._graph is None     # the CPU captures nothing


def test_streaming_financial_incremental_trend():
    """Live polls use an O(new-frames) incremental trend (warmup-overlap
    tail recompute); its output must be numerically indistinguishable from
    the full pass (rtol 1e-5, atol 1e-6; codes equal), and poll events must
    equal finalize's exact-pass events."""
    y = _loud_first_clip()
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              financial=True, device="cpu")
    rt._TREND_WARMUP = 64  # exercise several incremental appends
    rng = np.random.default_rng(2)
    pos = polls = 0
    while pos < len(y):
        n = int(rng.integers(3000, 12000))
        rt.feed(y[pos: pos + n])
        pos += n
        rt.poll_events()  # grow the cache incrementally
        polls += 1
    assert polls >= 3
    inc = rt._analysis()          # incremental path
    full = rt._analysis(exact=True)
    T = len(full["trend"])
    np.testing.assert_allclose(inc["trend"][:T], full["trend"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(inc["artic_codes"][:T], full["artic_codes"])
    np.testing.assert_array_equal(inc["slide_codes"][:T], full["slide_codes"])
    live = rt._extract({k: (v[:T] if getattr(v, "ndim", 0) else v)
                        for k, v in inc.items()})
    final = rt.finalize()
    assert [e["note"] for e in live] == [e["note"] for e in final]


def _discrete(events):
    return [{k: v for k, v in e.items() if not isinstance(v, float)}
            for e in events]


def test_poly_transcriber_is_not_ported():
    """It is ported now (the test keeps its earlier name): the live
    poly transcriber runs, keeps the JAX surface, and still refuses what a
    finalized stream must refuse."""
    rt = StreamingPolyTranscriber(sample_rate=SR, device="cpu")
    assert rt.poll_events() == [] and rt.frames_analyzed == 0
    assert 0 < rt.lookahead_s < 3.0
    assert (rt.hop, rt.n_fft, rt.tile, rt.halo) == (512, 2048, 24, 8)
    rt44 = StreamingPolyTranscriber(sample_rate=44100, device="cpu")
    assert (rt44.hop, rt44.n_fft) == (1024, 4096)
    assert rt44.lookahead_s == pytest.approx(rt.lookahead_s, rel=1e-3)
    tile_samp, ctx = 24 * 512, rt._ctx
    assert rt.feed(np.zeros(tile_samp, np.float32)) == 0
    assert rt.feed(np.zeros(ctx, np.float32)) == 1
    assert rt.finalize() == [] and rt.poll_events() == []
    with pytest.raises(RuntimeError, match="finalized"):
        rt.feed(np.zeros(10, np.float32))
    empty = StreamingPolyTranscriber(sample_rate=SR, device="cpu")
    assert empty.finalize() == []


@pytest.mark.parametrize("sr,tile,halo", [(22050, 16, 8), (22050, 24, 8),
                                          (44100, 24, 8)])
def test_live_poly_rows_and_events_match_jax(sr, tile, halo):
    """The same random chunks through both packages: per-tile rows within
    the module's tolerances, the mid-stream poll and finalize() equal in
    every discrete field, floats within 1e-5 where the picks are equal."""
    y, _ = generate_chord_progression(7, sr)
    jrt = JaxPolyStreaming(sample_rate=sr, tile_frames=tile, halo_frames=halo)
    rt = StreamingPolyTranscriber(sample_rate=sr, tile_frames=tile,
                                  halo_frames=halo, device="cpu")
    polls = _feed_randomly([rt, jrt], y, seed=1, poll_at=int(0.6 * len(y)))
    assert len(rt._rows) == len(jrt._rows) > 3
    V = 6
    for a, b in zip(rt._rows, jrt._rows):
        b = np.asarray(b)
        assert a.shape == b.shape == (tile, 2 * V + 2 + 42)
        assert float(np.mean(a[:, :V] == b[:, :V])) >= 0.999
        same = (a[:, :V] == b[:, :V]).all(axis=1)
        np.testing.assert_allclose(a[same, V:2 * V], b[same, V:2 * V],
                                   rtol=5e-4, atol=1e-4)
        np.testing.assert_allclose(a[:, 2 * V], b[:, 2 * V], atol=1e-6)
        np.testing.assert_allclose(a[:, 2 * V + 1], b[:, 2 * V + 1],
                                   atol=2e-3)
        np.testing.assert_allclose(unpack_cqt_f16(a[:, 2 * V + 2:], 84),
                                   unpack_cqt_f16(b[:, 2 * V + 2:], 84),
                                   rtol=2e-3, atol=1e-4)
    assert polls[0] and _discrete(polls[0]) == _discrete(polls[1])
    got, want = rt.finalize(), jrt.finalize()
    assert got
    assert_same_events(got, want, tol=1e-5 * 20)  # salience is ~1..15
    assert rt.frames_analyzed == jrt.frames_analyzed


@pytest.mark.parametrize("sr", [22050, 44100])
def test_live_poly_finalize_equals_the_offline_engine(sr):
    """finalize() gives the offline AegisPolyEngine's events on the same
    audio at F1 1.0 (the JAX package's own gate); at 22 050 Hz every
    discrete field is equal (the float fields carry the tile's int16 grid
    against the track's); at 44 100 Hz two starts of seed 7 sit one frame
    earlier live than offline, in the JAX package as well (its live
    finalize gives 51, its offline engine 52, for notes 53 and 57), so
    there the notes and ends are equal and the starts within one frame.
    Repeat calls, polls after finalize and a MIDI target agree."""
    import io
    y, _ = generate_chord_progression(7, sr)
    eng = AegisPolyEngine(sample_rate=sr, transport="int16", device="cpu")
    offline = eng.extract_events(eng.analyze(y))
    rt = StreamingPolyTranscriber(sample_rate=sr, device="cpu")
    _feed_randomly([rt], y, seed=0)
    live = rt.poll_events()
    got = rt.finalize()
    assert live and got
    if sr == 22050:
        assert _discrete(got) == _discrete(offline)
    else:
        assert [(e["note"], e["end"]) for e in got] == \
            [(e["note"], e["end"]) for e in offline]
        assert max(abs(a["start"] - b["start"])
                   for a, b in zip(got, offline)) <= 1
    m = note_event_f1(events_to_seconds(offline, sr, eng.hop_length),
                      events_to_seconds(got, sr, eng.hop_length))
    assert m["f1"] == 1.0, m
    assert rt.finalize() == got and rt.poll_events() == got
    buf = io.BytesIO()
    assert rt.finalize(buf) == got and buf.getvalue().startswith(b"MThd")
    # chunking does not matter
    rt2 = StreamingPolyTranscriber(sample_rate=sr, device="cpu")
    rt2.feed(y)
    assert rt2.finalize() == got


def test_live_poly_buffer_stays_bounded():
    y = np.tile(generate_chord_progression(3, SR)[0], 3)
    rt = StreamingPolyTranscriber(sample_rate=SR, device="cpu")
    worst = 0
    for i in range(0, len(y), 3000):
        rt.feed(y[i:i + 3000])
        worst = max(worst, len(rt._buf))
    assert worst <= rt._tile_samp + 2 * rt._ctx + 3000
    assert rt._buf_off > len(y) // 2
    assert rt._ref_power.shape == (1,) and float(rt._ref_power) > 0


def test_live_poly_use_onsets_false_polls_the_full_path():
    y, _ = generate_chord_progression(1, SR)
    rt = StreamingPolyTranscriber(sample_rate=SR, device="cpu",
                                  use_onsets=False)
    jrt = JaxPolyStreaming(sample_rate=SR, use_onsets=False)
    _feed_randomly([rt, jrt], y, seed=2)
    assert rt.poll_events() == rt._poll_full()
    assert _discrete(rt.finalize()) == _discrete(jrt.finalize())


# ---------------------------------------------------------------- the horizon

def _melody_clip(seconds, louder_at=None):
    """Looped short melody; optionally a mid-stream louder attack (peak
    fingerprint invalidation coverage)."""
    rng = np.random.default_rng(5)
    notes = [110.0, 146.83, 196.0, 164.81]
    parts, t, k = [], 0.0, 0
    while t < seconds:
        amp = 0.5
        if louder_at is not None and t >= louder_at:
            amp = 0.9 if t < louder_at + 0.8 else 0.6
        parts.append(amp * karplus_strong(notes[k % len(notes)], 0.7, SR,
                                          rng=rng))
        k += 1
        t += 0.7
    return _norm(np.concatenate(parts))


def _chug_clip(seconds):
    """Chain-merged same-pitch material (palm-mute chug: re-attacks whose
    gaps sit under the sustain merge), re-split at every onset."""
    rng = np.random.default_rng(9)
    parts, t = [], 0.0
    while t < seconds:
        parts.append(karplus_strong(110.0, 0.24, SR, rng=rng)[: int(0.23 * SR)])
        t += 0.23
    return _norm(np.concatenate(parts))


def _drive_horizon(rt, y, poll_every_s=3.0):
    """Feed in 0.5 s chunks; at each poll assert poll_events == _poll_full,
    dict for dict."""
    chunk = int(0.5 * SR)
    next_poll, cuts, polls = poll_every_s, [], 0
    for i in range(0, len(y), chunk):
        rt.feed(y[i:i + chunk])
        if (i + chunk) / SR >= next_poll:
            next_poll += poll_every_s
            got = rt.poll_events()
            full = rt._poll_full()
            polls += 1
            assert got == full, (len(got), len(full),
                                 [(a, b) for a, b in zip(got, full)
                                  if a != b][:2])
            if rt._hzn is not None:
                cuts.append(rt._hzn["cut"])
    assert polls >= 9
    return cuts


def test_horizon_poll_equals_full_poly():
    """Every poll of a 30 s chord stream equals the cache-free poll, the
    freeze cut engages and advances, and finalize is unaffected by it."""
    y7, _ = generate_chord_progression(7, SR)
    y3, _ = generate_chord_progression(3, SR)
    y = np.tile(np.concatenate([y7, y3]), 3)[: int(30 * SR)]
    rt = StreamingPolyTranscriber(sample_rate=SR, device="cpu")
    cuts = _drive_horizon(rt, y)
    assert cuts and cuts[-1] > cuts[0], cuts
    final = rt.finalize()
    assert final and rt.poll_events() == final


@pytest.mark.parametrize("case", ["v1_louder_midway", "financial", "v1_chug"])
def test_horizon_poll_equals_full(case):
    if case == "v1_louder_midway":
        y, kw = _melody_clip(30.0, louder_at=14.0), {"confidence_threshold": 0.5}
    elif case == "financial":
        y, kw = _melody_clip(35.0), {"financial": True}
    else:
        y, kw = _chug_clip(30.0), {"confidence_threshold": 0.5}
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              device="cpu", **kw)
    cuts = _drive_horizon(rt, y)
    if case != "v1_chug":
        assert cuts, "the horizon never engaged"
    if case == "v1_louder_midway":
        assert cuts[-1] > cuts[0], cuts  # the cut advanced
    # finalize is unaffected by the poll cache
    final = rt.finalize()
    assert final and rt.poll_events() == final
