"""PitchNet trainer: ``python -m aegis_tpu_torch.models.train [--steps N] ...``
(or ``python -m aegis_tpu_torch train``), the counterpart of
``aegis_tpu/models/train.py``.

The whole synthetic clip bank lives on the card (int16, one upload); each
step samples its crops there, featurizes them, runs the net, the loss,
backward and the AdamW update, and never waits for the card: the loss is
read on the host only at the log steps.  ``train(..., mesh=...)`` runs
the step data-parallel over a ``utils/mesh.py`` mesh of ranks (the global
crop batch split over every rank, the gradients added in rank order); the
command takes no mesh, as the JAX trainer's takes none.

``--out`` defaults to the packaged checkpoint,
``aegis_tpu_torch/models/weights/pitchnet_v1.npz``, as the JAX trainer's
does: training without ``--out`` replaces the weights the neural backend
runs.

Prints progress to stderr and a final JSON metrics line to stdout:
  {"loss": ..., "steps": ..., "train_s": ..., "rpa_50c": ...,
   "voicing_acc": ..., "median_cents_err": ..., "n_eval_frames": ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.models import pitchnet as pn
from aegis_tpu_torch.models.data import LABEL_HOP, make_clips
from aegis_tpu_torch.utils.mesh import Mesh, rank_device


def evaluate(net: pn.PitchNet, n_clips: int = 192, clip_len: int = 16384,
             seed: int = 777, windows_per_clip: int = 6,
             device="cuda") -> dict:
    """Held-out synthetic eval: raw pitch accuracy (<=50 cents), voicing
    accuracy, median |cents| error on voiced frames.  ``net`` must be on
    ``device``."""
    device = resolve_device(device)
    d = make_clips(n_clips, clip_len, seed=seed)
    y = d["tracks"].astype(np.float32) * d["scale"][:, None]
    offs = np.linspace(0, clip_len - pn.WIN, windows_per_clip).astype(int)
    wins, f0_true, v_true, w_true = [], [], [], []
    for o in offs:
        wins.append(y[:, o:o + pn.WIN])
        li = min((o + pn.WIN // 2) // LABEL_HOP, d["f0_hz"].shape[1] - 1)
        f0_true.append(d["f0_hz"][:, li])
        v_true.append(d["voiced"][:, li])
        w_true.append(d["label_w"][:, li])
    wins = np.concatenate(wins)
    f0_true = np.concatenate(f0_true)
    v_true = np.concatenate(v_true)
    # ambiguous frames (decay boundaries, reverb tails) carry no training
    # signal: scoring them would measure label noise, not the model
    keep = np.concatenate(w_true) > 0.0
    wins, f0_true, v_true = wins[keep], f0_true[keep], v_true[keep]

    with torch.no_grad():
        logits, vlogit = net(pn.featurize(torch.from_numpy(wins).to(device)))
        f0_hat, vprob = pn.decode_f0(logits, vlogit)
    f0_hat = f0_hat.cpu().numpy()
    # 0.4 = the production decode threshold (_neural_pitch): the gate must
    # measure the deployed operating point
    v_hat = vprob.cpu().numpy() > 0.4

    voicing_acc = float((v_hat == v_true).mean())
    m = v_true & (f0_true > 0)
    cents = 1200.0 * np.abs(np.log2(f0_hat[m] / f0_true[m]))
    return {
        "rpa_50c": float((cents <= 50).mean()) if m.any() else 0.0,
        "voicing_acc": voicing_acc,
        "median_cents_err": float(np.median(cents)) if m.any() else -1.0,
        "n_eval_frames": int(m.sum()),
    }


def train(steps: int = 3000, batch: int = 256, clips: int = 2048,
          clip_len: int = 16384, seed: int = 0, out: str | None = None,
          log_every: int = 200, data_kwargs: dict | None = None,
          device="cuda", log: Callable[[dict], None] | None = None,
          mesh: Mesh | None = None):
    """Train a fresh PitchNet on ``device``; returns (net, metrics) and
    writes the checkpoint to ``out`` when given.  ``log``, when given, gets
    what the progress lines print, unrounded: ``{"data_s": ...}`` once the
    bank is made, then ``{"step": i, "loss": ..., "elapsed_s": ...}`` at
    every log step.  On a ``mesh`` every rank holds the bank and a replica
    of the net, each step is data-parallel over the ranks
    (``pitchnet.make_train_step``), every rank returns the same net and
    metrics, and rank 0 alone prints and writes the checkpoint."""
    device = rank_device(mesh, device)
    lead = mesh is None or mesh.rank == 0
    if clip_len < 2 * pn.WIN:
        # the crop sampler needs room for a full window plus the attack
        # region; a smaller clip would give randint an empty range
        raise ValueError(f"clip_len must be >= {2 * pn.WIN} (got {clip_len})")
    t0 = time.time()
    d = make_clips(clips, clip_len, seed=seed, **(data_kwargs or {}))
    data_s = time.time() - t0
    if lead:
        print(f"# data: {clips} clips x {clip_len} samples "
              f"({data_s:.1f}s to synthesize)", file=sys.stderr)
    if log:
        log({"data_s": data_s})

    bank = {k: torch.from_numpy(d[k]).to(device)   # tracks stay int16
            for k in ("tracks", "scale", "f0_hz", "voiced", "label_w")}
    lr = pn.lr_schedule(steps)
    net, opt = pn.init_train_state(seed, lr=lr, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    step_fn = pn.make_train_step(batch, lr=lr, mesh=mesh)

    t0 = time.time()
    loss = None
    for i in range(steps):
        loss = step_fn(net, opt, gen, i, bank["tracks"], bank["scale"],
                       bank["f0_hz"], bank["voiced"], bank["label_w"])
        if i % log_every == 0 or i == steps - 1:
            record = {"step": i, "loss": float(loss),
                      "elapsed_s": time.time() - t0}
            if lead:
                print(f"# step {i:5d}  loss {record['loss']:.4f}  "
                      f"({record['elapsed_s']:.1f}s)", file=sys.stderr)
            if log:
                log(record)
    train_s = time.time() - t0
    if mesh is not None:   # every rank reports rank 0's time
        train_s = float(mesh.gather_world(
            torch.tensor([train_s], dtype=torch.float64,
                         device=device))[0][0])

    metrics = {"loss": float(loss), "steps": steps,
               "train_s": round(train_s, 1),
               **evaluate(net, device=device)}
    if out and lead:
        saved = pn.save_params(net, out, metrics=metrics)
        print(f"# saved {saved}", file=sys.stderr)
    return net, metrics


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The trainer's flags (the JAX trainer's, ``--device`` for its
    ``--platform``); also the ``train`` command's."""
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--clips", type=int, default=2048)
    ap.add_argument("--clip-len", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="checkpoint path (default: the packaged weights, "
                         "which the neural backend runs)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def run(args: argparse.Namespace) -> int:
    _, metrics = train(args.steps, args.batch, args.clips, args.clip_len,
                       args.seed, args.out or pn._DEFAULT_WEIGHTS,
                       device=args.device)
    print(json.dumps(metrics))
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(ap)
    run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
