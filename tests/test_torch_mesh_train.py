"""The port's data-parallel PitchNet paths on a mesh of gloo ranks (CPU
processes): the neural batch (``run_analyze_neural_batch``) and the neural
folder against the JAX package on a device mesh of the same shape, the
training step (``train_on_batch`` / ``make_train_step`` / ``train`` with a
mesh) against the JAX mesh step and the port's one-process step, and
``graft_entry_torch.dryrun_multichip`` at (2, 4).

One spawn a world size runs every case of that world; ``run_spmd`` checks
that every rank returned the same result, so the replicas' parameters are
equal bit for bit.  Tolerances: the neural rows at
tests/test_torch_pitchnet.py's, the loss at rtol 1e-5 (tests/test_torch_train.py)
and the parameters after the steps at 1e-6 absolute but where a gradient
near 0 lets the summation order flip AdamW's normalized step
(``assert_params_close``).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from aegis_tpu.engine.poly import transcribe_folder as jax_transcribe_folder
from aegis_tpu.models import data as jdata
from aegis_tpu.models import pitchnet as jpn
from aegis_tpu_torch.engine import folder as tfolder
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.models import pitchnet as tpn
from aegis_tpu_torch.models import train as ttrain
from aegis_tpu_torch.utils.mesh import call, run_calls, run_spmd

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 22050
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
BATCH, STEPS, LR = 16, 2, 3e-4


def tracks(seconds=0.5, seed=3, n=3):
    """Three tones with a decay and a little noise, made from a seed; an
    odd count, so silent filler tracks pad the batch to the world."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    ys = [(0.4 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(4 * np.pi * f * t))
          * np.exp(-t * rng.uniform(0.5, 2.0))
          + 0.002 * rng.standard_normal(len(t))
          for f in (196.0, 261.63, 146.83)[:n]]
    return np.stack(ys).astype(np.float32)


YS = tracks()
ROW_TOL = {"f0": ("rtol", 2e-6), "voiced_probs": ("atol", 5e-6),
           "rms": ("atol", 1e-7), "onset_env": ("atol", 5e-5),
           "mel_db": ("atol", 3e-3), "trend": ("rtol", 1e-4),
           "financial_confidence": ("atol", 3e-4),
           "combined_confidence": ("atol", 3e-4),
           "adaptive_threshold": ("atol", 1e-4),
           "distortion_score": ("atol", 1e-4)}


def jmesh(shape):
    d, t = shape
    return JMesh(np.array(jax.devices()[:d * t]).reshape(d, t),
                 ("data", "time"))


def assert_rows_match(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if a.dtype == bool or k in ("artic_codes", "slide_codes"):
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        m = ~np.isnan(b)
        how, tol = ROW_TOL[k]
        np.testing.assert_allclose(a[m], b[m], rtol=tol if how == "rtol" else 0,
                                   atol=tol if how == "atol" else 0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX trainer's step on a mesh per shape: the initial flax tree,
    the crops its step draws (``sample_windows`` at ``fold_in(key,
    step)``, as inside ``make_train_step``), its losses and parameters."""
    d = jdata.make_clips(16, clip_len=4096, seed=0)
    bank = [jax.numpy.asarray(d[k]) for k in ("tracks", "scale", "f0_hz",
                                              "voiced", "label_w")]
    tree = jax.tree_util.tree_map(np.asarray, jpn.init_params(0))
    key = jax.random.PRNGKey(1)
    batches = [tuple(np.asarray(a) for a in jpn.sample_windows(
        jax.random.fold_in(key, i), *bank[:4], BATCH, bank[4]))
        for i in range(STEPS)]
    out = {}
    for shape in (s for w in (2, 4) for s in MESHES[w]):
        params, opt_state = jpn.init_train_state(0)
        step = jpn.make_train_step(jmesh(shape), batch=BATCH)
        losses = []
        for i in range(STEPS):
            params, opt_state, loss = step(params, opt_state, key,
                                           np.int32(i), *bank)
            losses.append(float(loss))
        out[shape] = (losses, jax.tree_util.tree_map(np.asarray, params))
    return tree, batches, out


@pytest.fixture(scope="module")
def neural_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("neural_folder")
    ys = tracks(0.6, seed=9, n=2)
    write_wav(str(d / "a.wav"), ys[0], SR)
    write_wav(str(d / "b.wav"), ys[1][: int(0.45 * SR)], SR)
    return d


def world_calls(world, tree, batches, folder, out):
    calls, keys = [], []
    for shape in MESHES[world]:
        for fin in (False, True):
            calls.append(call(tpn.run_analyze_neural_batch, YS, SR, 512,
                              financial=fin, mesh_shape=shape))
            keys.append(("neural", fin, shape))
        if world < 8:
            for run in (0, 1):   # two runs: bitwise equal
                calls.append(call(tpn.train_on_batches, tree, batches,
                                  [LR] * STEPS, mesh_shape=shape))
                keys.append(("steps", run, shape))
    if world == 2:
        calls.append(call(tfolder.transcribe_folder, folder, out,
                          pitch_backend="neural", mesh_shape=(2, 1)))
        keys.append(("folder", (2, 1)))
        calls.append(call(ttrain.train, steps=3, batch=BATCH, clips=16,
                          clip_len=4096, seed=0, log_every=1,
                          mesh_shape=(2, 1)))
        keys.append(("train", (2, 1)))
    return calls, keys


def spawn(w, jax_steps, folder, out):
    """Every case of one world size, in one spawn of gloo ranks."""
    tree, batches, _ = jax_steps
    calls, keys = world_calls(w, tree, batches, str(folder), str(out))
    return dict(zip(keys, run_spmd(run_calls, *MESHES[w][0], calls,
                                   device="cpu")))


@pytest.fixture(scope="module")
def world2(jax_steps, neural_folder, tmp_path_factory):
    return spawn(2, jax_steps, neural_folder,
                 tmp_path_factory.mktemp("neural_out2"))


@pytest.fixture(scope="module")
def world4(jax_steps, neural_folder, tmp_path_factory):
    return spawn(4, jax_steps, neural_folder,
                 tmp_path_factory.mktemp("neural_out4"))


@pytest.fixture(scope="module")
def world8(jax_steps, neural_folder, tmp_path_factory):
    return spawn(8, jax_steps, neural_folder,
                 tmp_path_factory.mktemp("neural_out8"))


@pytest.mark.parametrize("w", [2, 4, 8])
def test_neural_batch_matches_jax_on_the_same_mesh(request, w):
    """Three tracks over 2, 4 and 8 ranks (silent filler tracks pad the
    batch and are dropped), v1 and financial rows."""
    res = request.getfixturevalue(f"world{w}")
    params = jpn.load_params()
    for shape in MESHES[w]:
        for fin in (False, True):
            got = res[("neural", fin, shape)]
            assert got["f0"].shape[0] == len(YS)
            ref = jpn.run_analyze_neural_batch(YS, SR, 512, params,
                                               financial=fin,
                                               mesh=jmesh(shape))
            assert_rows_match(got, ref)
            assert np.asarray(got["voiced_flag"]).mean() > 0.5


def test_neural_batch_needs_the_native_rate():
    with pytest.raises(ValueError, match="native-rate"):
        tpn.run_analyze_neural_batch(YS, 44100, 512, device="cpu")


@pytest.mark.parametrize("w", [2, 4])
def test_train_steps_match_jax_and_world_one(request, jax_steps, w):
    """The data-parallel step on the JAX step's own crops: the global loss
    within rtol 1e-5 of the JAX mesh step's and of the port's one-process
    step's, the parameters after the steps close (``assert_params_close``);
    two runs and every replica bitwise equal (run_spmd)."""
    res = request.getfixturevalue(f"world{w}")
    tree, batches, jax_out = jax_steps
    one_tree, one_losses = tpn.train_on_batches(tree, batches, [LR] * STEPS,
                                                device="cpu")
    for shape in MESHES[w]:
        got_tree, losses = res[("steps", 0, shape)]
        again = res[("steps", 1, shape)]
        assert all(np.isfinite(losses))
        assert np.array_equal(losses, again[1])
        for k in got_tree:
            for name in ("kernel", "bias"):
                np.testing.assert_array_equal(got_tree[k][name],
                                              again[0][k][name])
        jl, jparams = jax_out[shape]
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        for k in got_tree:
            for name in ("kernel", "bias"):
                assert_params_close(got_tree[k][name],
                                    np.asarray(jparams[k][name]))
                assert_params_close(got_tree[k][name], one_tree[k][name])


def assert_params_close(got, ref):
    """AdamW's normalized step moves a parameter by about the rate whatever
    the size of its gradient, so where a gradient is near 0 its summation
    order can flip the step: every element within 2 * STEPS * LR, all but
    1e-4 of them within 1e-6."""
    diff = np.abs(got - ref)
    assert diff.max() <= 2 * STEPS * LR
    assert (diff > 1e-6).mean() <= 1e-4


def test_train_on_a_mesh_equals_world_one(world2):
    """train(mesh=...) at (2, 1): the same metrics as the one-process
    trainer from the same seed (every rank the same net and metrics)."""
    net, metrics = world2[("train", (2, 1))]
    net1, ref = ttrain.train(steps=3, batch=BATCH, clips=16, clip_len=4096,
                             seed=0, log_every=1, device="cpu")
    assert metrics["steps"] == 3
    np.testing.assert_allclose(metrics["loss"], ref["loss"], rtol=1e-5)
    for k in ("rpa_50c", "voicing_acc", "n_eval_frames"):
        assert metrics[k] == ref[k], k
    for a, b in zip(net.parameters(), net1.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)


def test_neural_folder_matches_jax_on_the_same_mesh(world2, neural_folder,
                                                    tmp_path):
    got = world2[("folder", (2, 1))]
    ref = jax_transcribe_folder(str(neural_folder), str(tmp_path / "jax"),
                                pitch_backend="neural", mesh=jmesh((2, 1)))
    assert [n for _, _, n in got] == [n for _, _, n in ref]
    assert sum(n for _, _, n in got) > 0
    for (_, mid, _), (_, jmid, _) in zip(got, ref):
        assert midi_to_notes(mid) == midi_to_notes(jmid)


def test_dryrun_multichip_at_2_by_4(capsys):
    """The twin of __graft_entry__.dryrun_multichip on 8 CPU ranks: its line
    up to the losses is the JAX run's (MULTICHIP_r05.json: mesh (2, 4),
    out_frames (2, 22), the voiced share, the financial thresholds); the
    losses are finite."""
    import graft_entry_torch

    res = graft_entry_torch.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    jax_line = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    assert line.split(" train_loss=")[0] == \
        jax_line.strip().split(" train_loss=")[0]
    assert res["mesh"] == {"data": 2, "time": 4}
    assert res["out_frames"] == (2, 22)
    assert all(np.isfinite(res["losses"]))
