"""The PitchNet trainer of the port against the JAX package's, on the CPU.

The same inputs, made from a NumPy seed, go through both packages: the
copied clip synthesis, the cents target, the loss and its gradients, the
learning-rate schedule, the AdamW update, the init, the crop sampler, a
short training run, the checkpoint layout (read back by the JAX package),
the held-out evaluation and the ``train`` command.  Parameters cross with
``params_from_numpy`` / ``params_to_numpy``.  Every comparison states its
tolerance.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aegis_tpu.models import data as jdata
from aegis_tpu.models import pitchnet as jpn
from aegis_tpu.models import train as jtrain

from aegis_tpu_torch.models import data as tdata
from aegis_tpu_torch.models import pitchnet as tpn
from aegis_tpu_torch.models import train as ttrain

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def net_of(tree):
    return tpn.pitchnet_from_numpy(tree, "cpu")


def batch(seed, n=48, label_w=True):
    """Windows of noisy harmonic tones and noise, f0 labels (0 unvoiced),
    voicing and per-window loss weights."""
    rng = np.random.default_rng(seed)
    t = np.arange(tpn.WIN) / tpn.SR_NATIVE
    f0 = np.exp(rng.uniform(np.log(80), np.log(1000), n)).astype(np.float32)
    voiced = rng.random(n) < 0.75
    wins = (np.sin(2 * np.pi * f0[:, None] * t)
            + 0.3 * np.sin(4 * np.pi * f0[:, None] * t))
    wins = np.where(voiced[:, None], wins, 0.0) \
        + 0.05 * rng.standard_normal((n, tpn.WIN))
    wins = (wins * rng.uniform(0.1, 0.9, (n, 1))).astype(np.float32)
    f0 = np.where(voiced, f0, 0.0).astype(np.float32)
    w = rng.choice([0.0, 0.3, 1.0], n).astype(np.float32) if label_w else None
    return wins, f0, voiced, w


@pytest.mark.parametrize("fx_frac", [0.0, 1.0])
def test_copy_equals_its_original(fx_frac):
    """models/data.py is a copy: the same five arrays for any fx_frac (1.0
    runs every voiced clip through the copied effect chain)."""
    kw = dict(clip_len=4096, seed=3, fx_frac=fx_frac)
    a, b = tdata.make_clips(24, **kw), jdata.make_clips(24, **kw)
    assert sorted(a) == sorted(b) == ["f0_hz", "label_w", "scale", "tracks",
                                      "voiced"]
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (tdata.LABEL_HOP, tdata.DECAY_AMBIG_BLOCKS, tdata.ONSET_AMBIG_BLOCKS,
            tdata.ONSET_PRE_W) == (jdata.LABEL_HOP, jdata.DECAY_AMBIG_BLOCKS,
                                   jdata.ONSET_AMBIG_BLOCKS, jdata.ONSET_PRE_W)


def test_pitch_target_matches_xla():
    """The ratio f0 / FMIN_HZ is XLA's product with the float32 reciprocal,
    bit for bit; the target within 1e-5 of the jitted JAX one: XLA's log2
    is ulps off torch's on ~40 % of frames and the Gaussian turns an ulp of
    a cents value near 4000 into ~5e-6 of a target (the JAX package's own
    eager and jitted targets differ by 4.8e-6 on these inputs)."""
    rng = np.random.default_rng(0)
    f0 = np.exp(rng.uniform(np.log(70), np.log(1300), 4096)).astype(np.float32)
    f0[:50] = 0.0
    voiced = rng.random(4096) < 0.8
    ratio = jax.jit(lambda f: jnp.maximum(f, 1e-3) / jpn.FMIN_HZ)(f0)
    got_ratio = (torch.clamp_min(torch.from_numpy(f0), 1e-3)
                 * np.float32(1.0 / tpn.FMIN_HZ))
    np.testing.assert_array_equal(got_ratio.numpy(), np.asarray(ratio))
    ref = np.asarray(jax.jit(jpn.pitch_target)(f0, voiced))
    got = tpn.pitch_target(torch.from_numpy(f0), torch.from_numpy(voiced))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[~voiced], ref[~voiced])


@pytest.mark.parametrize("with_label_w", [False, True])
def test_loss_and_gradients_match_jax(with_label_w):
    """The loss within 1e-5 relative and every gradient within 1e-4 of its
    layer's largest, against ``jax.value_and_grad(loss_fn)`` jitted as the
    JAX trainer runs it."""
    tree = jax.tree_util.tree_map(np.asarray, jpn.init_params(4))
    wins, f0, voiced, w = batch(1, label_w=with_label_w)
    vg = jax.jit(jax.value_and_grad(jpn.loss_fn), static_argnums=4)
    loss_j, grads_j = vg(tree, wins, f0, voiced, jpn.HIDDEN,
                         None if w is None else jnp.asarray(w))
    net = net_of(tree)
    loss_t = tpn.loss_fn(net, torch.from_numpy(wins), torch.from_numpy(f0),
                         torch.from_numpy(voiced),
                         None if w is None else torch.from_numpy(w))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    layers = (*net.trunk, net.pitch, net.voiced)
    assert len(layers) == len(grads_j)
    for k, layer in enumerate(layers):
        gj = grads_j[f"Dense_{k}"]
        for got, ref in ((layer.weight.grad.numpy().T, gj["kernel"]),
                         (layer.bias.grad.numpy(), gj["bias"])):
            ref = np.asarray(ref)
            assert np.abs(ref).max() > 0
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("steps", [120, 3000])
def test_lr_schedule_matches_optax(steps):
    ref = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps,
        end_value=1e-5)
    lr = tpn.lr_schedule(steps)
    got = np.array([lr(i) for i in range(steps)])
    want = np.array([float(ref(i)) for i in range(steps)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0
    assert got[1] == pytest.approx(3e-4 / min(100, steps // 10 + 1), rel=1e-5)
    if steps == 3000:
        assert got.argmax() == 100
        assert lr(3000) == pytest.approx(1e-5)


def test_adamw_steps_match_optax():
    """Eight AdamW updates (the schedule of a 20-step run: warmup, then
    cosine) on the same gradients, from the same parameters: within 1e-6
    absolute of optax.adamw."""
    tree = jax.tree_util.tree_map(np.asarray, jpn.init_params(0, hidden=(64,)))
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=3,
                                               decay_steps=20, end_value=1e-5)
    opt_j = optax.adamw(sched, weight_decay=1e-5)
    state = opt_j.init(tree)
    params_j = tree
    net = net_of(tree)
    net.train()
    lr = tpn.lr_schedule(20)
    opt_t = torch.optim.AdamW(net.parameters(), lr=lr(0), betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-5)
    layers = (*net.trunk, net.pitch, net.voiced)
    rng = np.random.default_rng(8)
    for i in range(8):
        grads = {f"Dense_{k}": {
            "kernel": (rng.standard_normal((l.in_features, l.out_features))
                       * 10.0 ** rng.uniform(-4, -1)).astype(np.float32),
            "bias": (rng.standard_normal(l.out_features) * 1e-2
                     ).astype(np.float32)} for k, l in enumerate(layers)}
        updates, state = opt_j.update(grads, state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for k, layer in enumerate(layers):
            layer.weight.grad = torch.from_numpy(grads[f"Dense_{k}"]["kernel"].T.copy())
            layer.bias.grad = torch.from_numpy(grads[f"Dense_{k}"]["bias"])
        for group in opt_t.param_groups:
            group["lr"] = lr(i)
        opt_t.step()
    got = tpn.params_to_numpy(net)
    moved = 0.0
    for k in got:
        for name in ("kernel", "bias"):
            ref = np.asarray(params_j[k][name])
            np.testing.assert_allclose(got[k][name], ref, rtol=0, atol=1e-6)
            moved = max(moved, np.abs(ref - tree[k][name]).max())
    assert moved > 1e-4   # the steps moved the parameters


def test_init_follows_flax_dense():
    """Weights from a normal truncated at two sigma, std sqrt(1 / fan_in),
    zero biases, as flax's Dense init (JAX's own draw beside it); one seed
    one net, another seed another."""
    net = tpn.init_params(0, device="cpu")
    ref = jpn.init_params(0)
    layers = (*net.trunk, net.pitch, net.voiced)
    for k, layer in enumerate(layers):
        w = layer.weight.detach().numpy()
        fan_in = w.shape[1]
        std = np.sqrt(1.0 / fan_in)
        sigma = std / 0.87962566103423978
        assert np.abs(w).max() <= 2 * sigma
        assert np.all(layer.bias.detach().numpy() == 0)
        if w.size > 1000:
            assert w.std() == pytest.approx(std, rel=0.02), k
            jw = np.asarray(ref[f"Dense_{k}"]["kernel"])
            assert w.std() == pytest.approx(jw.std(), rel=0.03), k
            assert np.abs(w).max() == pytest.approx(np.abs(jw).max(), rel=0.02)
    again = tpn.params_to_numpy(tpn.init_params(0, device="cpu"))
    other = tpn.params_to_numpy(tpn.init_params(1, device="cpu"))
    first = tpn.params_to_numpy(net)
    np.testing.assert_array_equal(again["Dense_0"]["kernel"],
                                  first["Dense_0"]["kernel"])
    assert not np.array_equal(other["Dense_0"]["kernel"],
                              first["Dense_0"]["kernel"])


def test_crop_batch_and_attack_share():
    """Explicit crops equal a NumPy crop (windows, labels at the window
    centre, weights); the sampler draws 35 % of its offsets from the attack
    region, so the share below WIN is 0.35 + 0.65 * WIN / (L - WIN + 1)."""
    d = tdata.make_clips(12, 6000, seed=2)
    bank = [torch.from_numpy(d[k]) for k in ("tracks", "scale", "f0_hz",
                                             "voiced", "label_w")]
    rng = np.random.default_rng(5)
    ci = rng.integers(0, 12, 40)
    off = rng.integers(0, 6000 - tpn.WIN + 1, 40)
    off[:3] = (0, 6000 - tpn.WIN, 6000 - tpn.WIN - 17)
    wins, f0b, vb, wb = tpn.crop_batch(*bank[:4], torch.from_numpy(ci),
                                       torch.from_numpy(off), bank[4])
    ref = np.stack([d["tracks"][c, o:o + tpn.WIN].astype(np.float32)
                    * d["scale"][c] for c, o in zip(ci, off)])
    np.testing.assert_array_equal(wins.numpy(), ref)
    lab = np.clip((off + tpn.WIN // 2) // tdata.LABEL_HOP, 0,
                  d["f0_hz"].shape[1] - 1)
    np.testing.assert_array_equal(f0b.numpy(), d["f0_hz"][ci, lab])
    np.testing.assert_array_equal(vb.numpy(), d["voiced"][ci, lab])
    np.testing.assert_array_equal(wb.numpy(), d["label_w"][ci, lab])

    L = 32000   # a ramp bank: each window's first sample is its offset
    ramp = torch.arange(L, dtype=torch.int16).repeat(4, 1)
    gen = torch.Generator()
    gen.manual_seed(0)
    wins, *_ = tpn.sample_windows(gen, ramp, torch.ones(4),
                                  torch.zeros(4, L // 128),
                                  torch.zeros(4, L // 128, dtype=torch.bool),
                                  4096)
    offs = wins[:, 0].numpy()
    assert offs.min() >= 0 and offs.max() <= L - tpn.WIN
    np.testing.assert_array_equal(wins[:, -1].numpy(), offs + tpn.WIN - 1)
    share = float((offs < tpn.WIN).mean())
    assert abs(share - (0.35 + 0.65 * tpn.WIN / (L - tpn.WIN + 1))) < 0.05


def test_train_step_learns():
    """The JAX package's learning gate (tests/test_pitchnet.py) on the
    port: hidden (64,), batch 64, 96 clips x 4096, 120 steps at 3e-4."""
    d = tdata.make_clips(96, clip_len=4096, seed=11)
    bank = [torch.from_numpy(d[k]) for k in ("tracks", "scale", "f0_hz",
                                             "voiced", "label_w")]
    net, opt = tpn.init_train_state(0, hidden=(64,), device="cpu")
    step = tpn.make_train_step(64)
    gen = torch.Generator()
    gen.manual_seed(2)
    losses = [float(step(net, opt, gen, i, *bank)) for i in range(120)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])


def test_train_hands_its_log_to_the_caller(capsys):
    """``train(log=...)`` gets the data seconds once, then every log step's
    loss unrounded: the numbers the progress lines print, the last of them
    the final metrics' loss."""
    records = []
    _, metrics = ttrain.train(steps=5, batch=8, clips=8, clip_len=4096,
                              log_every=2, device="cpu", log=records.append)
    assert set(records[0]) == {"data_s"} and records[0]["data_s"] >= 0
    steps = records[1:]
    assert [r["step"] for r in steps] == [0, 2, 4]
    assert all(np.isfinite(r["loss"]) and r["elapsed_s"] >= 0 for r in steps)
    assert steps[-1]["loss"] == metrics["loss"]
    err = capsys.readouterr().err
    assert f"({records[0]['data_s']:.1f}s to synthesize)" in err
    for r in steps:
        assert f"# step {r['step']:5d}  loss {r['loss']:.4f}" in err


def test_checkpoint_loads_in_the_jax_package(tmp_path):
    """A checkpoint the port writes is the JAX layout: the JAX package's
    load_params reads it, its meta record is the JAX trainer's, and flax's
    logits on it are within 1e-6 of their range of the port's on the same
    file (the two float32 matmuls sum in other orders, as in
    tests/test_torch_pitchnet.py::test_logits_match_flax)."""
    net = tpn.init_params(3, device="cpu")
    path = tpn.save_params(net, str(tmp_path / "w"), metrics={"loss": 1.5})
    assert path.endswith(".npz")
    tree_j = jpn.load_params(path)
    meta = jpn.load_meta(path)
    assert meta["feature_version"] == jpn.FEATURE_VERSION
    assert meta["metrics"] == {"loss": 1.5}
    assert meta["hidden"] == list(jpn.HIDDEN)
    with np.load(path) as z:
        assert all(z[k].dtype == np.float16 for k in z.files if k != "__meta__")
    src = tpn.params_to_numpy(net)
    for k in src:
        for name in ("kernel", "bias"):
            np.testing.assert_array_equal(
                tree_j[k][name], src[k][name].astype(np.float16))
    wins = batch(7)[0]
    feats = jpn.featurize(jnp.asarray(wins))
    logits_j, vlogit_j = jpn.apply_model(tree_j, feats)
    loaded = net_of(tpn.load_params(path))
    with torch.no_grad():
        logits_t, vlogit_t = loaded(torch.from_numpy(np.asarray(feats)))
    for got, ref in ((logits_t, logits_j), (vlogit_t, vlogit_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.ptp(ref))
    # a checkpoint of other features names the port's own trainer
    z = dict(np.load(path))
    z["__meta__"] = np.frombuffer(json.dumps(
        dict(meta, feature_version=99)).encode(), dtype=np.uint8).copy()
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="python -m aegis_tpu_torch train"):
        tpn.load_params(path)


def test_evaluate_matches_jax():
    """The held-out evaluation of the committed checkpoint on 24 clips:
    the same frames scored, each rate within one frame of JAX's."""
    tree = jpn.load_params()
    ref = jtrain.evaluate(tree, n_clips=24)
    got = ttrain.evaluate(net_of(tree), n_clips=24, device="cpu")
    assert sorted(got) == sorted(ref)
    assert got["n_eval_frames"] == ref["n_eval_frames"] > 0
    d = tdata.make_clips(24, 16384, seed=777)
    offs = np.linspace(0, 16384 - tpn.WIN, 6).astype(int)
    kept = sum(int((d["label_w"][:, min((o + tpn.WIN // 2) // 128,
                                        d["label_w"].shape[1] - 1)] > 0).sum())
               for o in offs)
    assert abs(got["rpa_50c"] - ref["rpa_50c"]) <= 1.0 / ref["n_eval_frames"]
    assert abs(got["voicing_acc"] - ref["voicing_acc"]) <= 1.0 / kept
    assert got["median_cents_err"] == pytest.approx(ref["median_cents_err"],
                                                    abs=0.05)


def test_cli_train_prints_the_jax_keys(tmp_path):
    """``python -m aegis_tpu_torch train`` on the CPU: a tiny run into
    tmp_path prints the JAX trainer's metric keys and writes a checkpoint
    both packages load; the packaged checkpoint is untouched.  A clip
    shorter than two windows raises."""
    weights = REPO / "aegis_tpu_torch/models/weights/pitchnet_v1.npz"
    before = hashlib.sha256(weights.read_bytes()).hexdigest()
    out = tmp_path / "ck.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "train", "--steps", "3",
         "--batch", "8", "--clips", "8", "--clip-len", "4096",
         "--out", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    _, ref = jtrain.train(steps=2, batch=8, clips=8, clip_len=4096)
    assert sorted(got) == sorted(ref)
    assert got["steps"] == 3 and np.isfinite(got["loss"])
    assert "# step     0" in proc.stderr and f"# saved {out}" in proc.stderr
    assert jpn.load_meta(str(out))["metrics"] == got
    tpn.load_params(str(out))
    assert hashlib.sha256(weights.read_bytes()).hexdigest() == before
    for mod in (ttrain, jtrain):
        with pytest.raises(ValueError, match="clip_len"):
            mod.train(steps=1, clips=2, clip_len=4095,
                      **({"device": "cpu"} if mod is ttrain else {}))
