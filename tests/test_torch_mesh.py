"""The port's multi-device paths on a mesh of gloo ranks (CPU processes)
against the JAX package on a device mesh of the same shape, and against
the port's own one-process programs: the tiled batch (v1 and financial),
the single-track tiles, the streamed mode, the polyphonic tiles and the
folder sweep, at meshes (1, 2), (2, 1), (2, 2) and (2, 4), plus (1, 4) and
(1, 8) for the one-track paths.

One spawn a world size (2, 4, 8 ranks) runs every case of that world
(``utils.mesh.run_calls``); ``run_spmd`` checks that every rank returned
the same result.  The JAX package runs on the suite's 8 CPU devices
(tests/conftest.py).  Tolerances are the one-device parity tests'
(tests/test_torch_turbo.py); every discrete row is equal.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh

from aegis_tpu.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu.engine import turbo as jturbo
from aegis_tpu.engine.poly import transcribe_folder as jax_transcribe_folder
from aegis_tpu_torch import config as tconfig
from aegis_tpu_torch.engine import folder as tfolder
from aegis_tpu_torch.engine import turbo as tturbo
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.tools.signal_gen import generate_test_track
from aegis_tpu_torch.utils import mesh as tmesh
from aegis_tpu_torch.utils.mesh import call, run_calls, run_spmd

torch.set_num_threads(1)

SR = 22050
AUDIO, PYIN = AudioConfig(sample_rate=SR), PyinConfig()
SMALL = TurboConfig(tile_frames=16, halo_frames=8)
TAUDIO, TPYIN = tconfig.AudioConfig(sample_rate=SR), tconfig.PyinConfig()
TSMALL = tconfig.TurboConfig(**dataclasses.asdict(SMALL))

DISCRETE = ("voiced_flag", "rake_mask", "mute_mask", "artic_codes",
            "slide_codes")


def tracks(seconds=0.5, seed=3):
    """Two tones with a decay and a little noise, made from a seed: 22
    frames at 0.5 s, so 2 tiles of 16 (padded to 4 on a time axis of 4)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    ys = [(0.4 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(4 * np.pi * f * t))
          * np.exp(-t * rng.uniform(0.5, 2.0))
          + 0.002 * rng.standard_normal(len(t)) for f in (196.0, 261.63)]
    return np.stack(ys).astype(np.float32)


YS = tracks()
LONG = generate_test_track(sr=SR)[0][:2 * SR]   # 87 frames: 6 tiles
# the port's meshes a world size runs, and the (1, world) mesh of the
# one-track paths
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
ROW = {2: (1, 2), 4: (1, 4), 8: (1, 8)}
# the streamed mode's slab: several slabs at (1, 2), one at (1, 4) / (1, 8)
STREAM = {2: dict(slab_tiles=2, transport="int8"),
          4: dict(financial=True, transport="int16"),
          8: dict(transport="int8")}


def jmesh(shape):
    d, t = shape
    return JMesh(np.array(jax.devices()[:d * t]).reshape(d, t),
                 ("data", "time"))


def rows_match(got, ref, rows=None, f0_rtol=1e-4, atol=1e-4):
    """The port's rows against the JAX package's: shapes equal, discrete
    rows equal, floats at the one-device parity tests' tolerances."""
    for k in rows or ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k in DISCRETE:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in ("f0", "trend"):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=k)
            m = ~np.isnan(r)
            assert np.max(np.abs(g[m] - r[m]) / np.abs(r[m]),
                          initial=0.0) < f0_rtol, k
        elif k == "mel_db":   # dB of matmul-DFT power (test_torch_turbo.py)
            assert np.abs(g - r).max() < 2e-3, k
        else:
            np.testing.assert_allclose(g, r, atol=atol, err_msg=k)


def same_as_one_process(got, ref):
    """The mesh program against the port's one-process program on a tile
    count the time axis divides: every row equal, the distortion score
    up to its summation order."""
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "distortion_score":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    """Two WAVs of different lengths (0.6 s and 0.45 s)."""
    d = tmp_path_factory.mktemp("mesh_folder")
    ys = tracks(0.6, seed=9)
    write_wav(str(d / "a.wav"), ys[0], SR)
    write_wav(str(d / "b.wav"), ys[1][: int(0.45 * SR)], SR)
    return d


def world_calls(world, folder, out):
    calls, keys = [], []
    for shape in MESHES[world]:
        for fin in (False, True):
            calls.append(call(tturbo.run_analyze_batch, YS, TAUDIO, TPYIN, 0.6,
                              TSMALL, financial=fin, mesh_shape=shape))
            keys.append(("batch", fin, shape))
        calls.append(call(tturbo.run_analyze_poly_turbo, YS, sr=SR,
                          turbo=TSMALL, mesh_shape=shape))
        keys.append(("poly", shape))
        engines = ("v1", "financial", "poly") if world == 4 else ("v1",)
        for engine in engines:
            calls.append(call(tfolder.transcribe_folder, folder,
                              os.path.join(out, f"{engine}_{shape}"),
                              engine=engine, turbo=TSMALL, mesh_shape=shape))
            keys.append(("folder", engine, shape))
    row = ROW[world]
    calls.append(call(tturbo.run_analyze_turbo, YS[0], TAUDIO, TPYIN, 0.6,
                      TSMALL, financial=world == 2, mesh_shape=row))
    keys.append(("turbo", row))
    calls.append(call(tturbo.run_analyze_streamed, LONG, TAUDIO, TPYIN, 0.6,
                      TSMALL, **STREAM[world], mesh_shape=row))
    keys.append(("stream", row))
    return calls, keys


@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda w: f"world{w}")
def world(request, wav_folder, tmp_path_factory):
    """Every case of one world size, in one spawn of gloo ranks."""
    w = request.param
    out = str(tmp_path_factory.mktemp(f"mesh_out{w}"))
    calls, keys = world_calls(w, str(wav_folder), out)
    results = run_spmd(run_calls, *MESHES[w][0], calls, device="cpu")
    return w, out, dict(zip(keys, results))


def test_tiled_batch_matches_jax_and_one_process(world):
    w, _, res = world
    for shape in MESHES[w]:
        for fin in (False, True):
            got = res[("batch", fin, shape)]
            ref = jturbo.run_analyze_batch(YS, AUDIO, PYIN, 0.6, turbo=SMALL,
                                           mesh=jmesh(shape), financial=fin)
            rows_match(got, ref)
            for k in ("adaptive_threshold", "distortion_score"):
                if fin:
                    assert got[k].shape == (2,)
                    np.testing.assert_allclose(got[k], ref[k], atol=1e-4)
            if 2 % shape[1] == 0:   # the time axis divides the 2 tiles
                same_as_one_process(got, tturbo.run_analyze_batch(
                    YS, TAUDIO, TPYIN, 0.6, TSMALL, financial=fin,
                    device="cpu"))


def test_poly_tiles_match_jax_and_one_process(world):
    w, _, res = world
    for shape in MESHES[w]:
        got = res[("poly", shape)]
        ref = jturbo.run_analyze_poly_turbo(YS, sr=SR, turbo=SMALL,
                                            mesh=jmesh(shape))
        for k in ("roll", "confidence", "salience", "rms", "onset_env"):
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            assert g.shape == r.shape, k
            if r.dtype == bool:
                np.testing.assert_array_equal(g, r, err_msg=k)
            else:   # test_torch_poly.py's tiled tolerance
                np.testing.assert_allclose(g, r, rtol=5e-4, atol=1e-5,
                                           err_msg=k)
        assert got["roll"].any()
        if 2 % shape[1] == 0:
            same_as_one_process(got, tturbo.run_analyze_poly_turbo(
                YS, sr=SR, turbo=TSMALL, device="cpu"))


def test_single_track_tiles_and_stream_match_jax(world):
    """run_analyze_turbo and run_analyze_streamed on a (1, world) row:
    the tile count padded up to the time axis (2 tiles on 4 and 8 ranks,
    6 on 8), several slabs on 2 ranks, the int8 and int16 transports."""
    w, _, res = world
    row = ROW[w]
    fin = w == 2
    got = res[("turbo", row)]
    ref = jturbo.run_analyze_turbo(YS[0], AUDIO, PYIN, 0.6, turbo=SMALL,
                                   mesh=jmesh(row), financial=fin)
    rows_match(got, ref)
    if fin:
        for k in ("adaptive_threshold", "distortion_score"):
            assert abs(float(got[k]) - float(ref[k])) < 1e-4, k
    if row == (1, 2):
        same_as_one_process(got, tturbo.run_analyze_turbo(
            YS[0], TAUDIO, TPYIN, 0.6, TSMALL, financial=fin, device="cpu"))

    got = res[("stream", row)]
    ref = jturbo.run_analyze_streamed(LONG, AUDIO, PYIN, 0.6, turbo=SMALL,
                                      mesh=jmesh(row), **STREAM[w])
    rows_match(got, ref)
    if STREAM[w].get("financial"):
        for k in ("adaptive_threshold", "distortion_score"):
            assert abs(float(got[k]) - float(ref[k])) < 1e-4, k
    if row == (1, 2):   # 3 slabs of 2 tiles: the one-process slabs
        same_as_one_process(got, tturbo.run_analyze_streamed(
            LONG, TAUDIO, TPYIN, 0.6, TSMALL, device="cpu", **STREAM[w]))


def test_folder_matches_jax_on_the_same_mesh(world, wav_folder, tmp_path):
    """transcribe_folder(mesh=...): the same event counts and MIDI notes as
    the JAX package's on a device mesh of the same shape; rank 0 alone
    wrote the files."""
    w, out, res = world
    for (kind, engine, shape), got in ((k, v) for k, v in res.items()
                                       if k[0] == "folder"):
        ref = jax_transcribe_folder(str(wav_folder),
                                    str(tmp_path / f"{engine}_{shape}"),
                                    engine=engine, turbo=SMALL,
                                    mesh=jmesh(shape))
        assert [os.path.basename(p) for p, _, _ in got] == ["a.wav", "b.wav"]
        assert [n for _, _, n in got] == [n for _, _, n in ref], engine
        assert sum(n for _, _, n in got) > 0
        for (_, mid, _), (_, jmid, _) in zip(got, ref):
            assert midi_to_notes(mid) == midi_to_notes(jmid), (engine, mid)


def test_one_rank_mesh_equals_the_one_process_program(tmp_path):
    """A world of one gloo rank in this process: a (1, 1) mesh, and no mesh
    in the initialized world (the JAX default over every rank), give the
    one-process program's rows exactly; the halo check refuses a block
    shorter than its context."""
    ref = tturbo.run_analyze_batch(YS, TAUDIO, TPYIN, 0.6, TSMALL,
                                   financial=True, device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        m = tmesh.Mesh(1, 1, device="cpu")
        assert m.shape == {"data": 1, "time": 1} and m.staging == "none"
        # a call that names no mesh builds the world's default one once
        assert tmesh.default_mesh(device="cpu") is \
            tmesh.resolve_mesh(None, "cpu", batch=2)[0]
        for mesh in (m, None):
            got = tturbo.run_analyze_batch(YS, TAUDIO, TPYIN, 0.6, TSMALL,
                                           financial=True, device="cpu",
                                           mesh=mesh)
            assert tmesh.results_equal(got, ref)
        with pytest.raises(ValueError, match="halo context"):
            tturbo.run_analyze_batch(   # one tile of 2 frames, 1024 samples
                YS[:, :1000], TAUDIO, TPYIN, 0.6,
                tconfig.TurboConfig(tile_frames=2, halo_frames=8),
                device="cpu", mesh=m)
        with pytest.raises(ValueError, match="differs from the mesh"):
            tturbo.run_analyze_batch(YS, TAUDIO, TPYIN, mesh=m)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            tmesh.Mesh(1, 2, device="cpu")
        with pytest.raises(ValueError, match="takes gloo"):
            tmesh.Mesh(1, 1, device="cpu", backend="nccl")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_collectives_on_one_rank_and_solo():
    """The one-process stand-in does no communication: the halo is empty at
    both ends and every reduction is the identity."""
    x = torch.arange(6.0).reshape(2, 3)
    solo = tmesh.SOLO
    assert solo.halo(x, x) == (None, None)
    assert solo.pmax_time(x) is x and solo.psum_world(x) is x
    assert solo.gather_world(x) == [x]
    assert tmesh.results_equal({"a": [np.float32(np.nan), x]},
                               {"a": [np.float32(np.nan), x.clone()]})
    assert not tmesh.results_equal({"a": x}, {"a": x + 1})


def test_a_failing_rank_fails_the_run_and_names_itself():
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"):
        run_spmd(tturbo.run_analyze_batch, 2, 1, YS[:1], TAUDIO, TPYIN,
                 device="cpu")


def test_nccl_needs_a_card():
    with pytest.raises(RuntimeError, match="is_available"):
        run_spmd(tturbo.run_analyze_batch, 1, 2, YS, TAUDIO, TPYIN)
