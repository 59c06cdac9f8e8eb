"""Root entry points of aegis_tpu_torch, the PyTorch / CUDA port.

* ``dryrun_multichip(n)`` — the twin of ``__graft_entry__.py``'s: the
  sharded analyze steps over an n-rank (data, time) mesh of processes
  (``aegis_tpu_torch/utils/mesh.py``): the track batch over "data", the
  audio's time tiles (with pYIN halo context) over "time", the per-track
  dB reference a MAX all-reduce over the time row; then the financial and
  polyphonic programs, the neural financial batch (when the weights are
  present) and two data-parallel PitchNet training steps.  Tiny shapes;
  one real step each.  Prints one ``dryrun_multichip OK: ...`` line.

    python3 -c "import graft_entry_torch as g; g.dryrun_multichip(8, device='cpu')"

The ranks run on the card by default (NCCL, one card a rank); ranks that
share a card name ``backend="gloo"``; ``device="cpu"`` (gloo) runs them on
CPU processes.  There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np


def _dryrun_rank(n_devices: int, *, mesh, device="cuda") -> dict:
    """One rank's part of ``dryrun_multichip``: every check, and the numbers
    of its line (the same on every rank)."""
    import torch

    from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
    from aegis_tpu_torch.engine.turbo import (run_analyze_batch,
                                              run_analyze_poly_turbo)
    from aegis_tpu_torch.models import pitchnet as pn
    from aegis_tpu_torch.models.data import make_clips

    audio = AudioConfig(sample_rate=22050)
    pyin_cfg = PyinConfig()
    turbo = TurboConfig(tile_frames=16, halo_frames=8)

    # batch of tiny independent tracks (data parallel), each tiled over time
    sr = audio.sample_rate
    t = np.arange(sr // 2) / sr
    ys = np.stack([(0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)
                   for f in (196.0, 261.63)])

    out = run_analyze_batch(ys, audio, pyin_cfg, 0.6, turbo=turbo,
                            device=device, mesh=mesh)
    assert out["f0"].shape[0] == ys.shape[0]
    assert out["f0"].shape[1] == audio.n_frames(ys.shape[1])
    # voiced pitch must be detected on both tracks (sanity, not just a run)
    for b in range(ys.shape[0]):
        assert np.asarray(out["voiced_flag"][b]).mean() > 0.5, \
            "no pitch detected"

    # the financial (v2) analysis over the same mesh: guitar filters per
    # haloed tile, the trend rows all-gathered over the time row, the
    # distortion sums added in rank order
    fin = run_analyze_batch(ys, audio, pyin_cfg, 0.6, turbo=turbo,
                            financial=True, device=device, mesh=mesh)
    assert fin["trend"].shape == fin["f0"].shape
    assert fin["adaptive_threshold"].shape == (ys.shape[0],)
    assert np.isfinite(fin["adaptive_threshold"]).all()

    # the polyphonic (CQT salience-peeling) program over the same mesh
    poly = run_analyze_poly_turbo(ys, sr=sr, turbo=turbo, device=device,
                                  mesh=mesh)
    assert poly["roll"].shape[0] == ys.shape[0]
    assert poly["roll"].any(), "no polyphonic activation detected"

    # neural inference over the same mesh: the financial program
    # data-parallel over the tracks
    if pn.have_default_weights():
        nout = pn.run_analyze_neural_batch(
            ys, sr, audio.hop_length, pn.default_params(mesh.device),
            financial=True, device=device, mesh=mesh)
        assert nout["f0"].shape == out["f0"].shape
        assert np.asarray(nout["voiced_flag"]).mean() > 0.5

    # the PitchNet training step data-parallel over every rank
    d = make_clips(n_devices * 4, clip_len=4096, seed=0)
    bank = [torch.from_numpy(d[k]).to(mesh.device)
            for k in ("tracks", "scale", "f0_hz", "voiced", "label_w")]
    net, opt = pn.init_train_state(0, device=mesh.device)
    step_fn = pn.make_train_step(batch=8 * n_devices, mesh=mesh)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(1)
    losses = [float(step_fn(net, opt, gen, i, *bank)) for i in range(2)]
    assert all(np.isfinite(v) for v in losses), losses

    return {"mesh": dict(mesh.shape), "out_frames": tuple(out["f0"].shape),
            "voiced": float(np.asarray(out["voiced_flag"]).mean()),
            "fin_thr": np.asarray(fin["adaptive_threshold"]).round(3).tolist(),
            "losses": losses}


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """Run the sharded steps on an n-rank mesh (data 2 when n is even, as
    the JAX dryrun's), print the ``dryrun_multichip OK`` line and return
    its numbers."""
    from aegis_tpu_torch.utils.mesh import run_spmd

    data_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    res = run_spmd(_dryrun_rank, data_axis, n_devices // data_axis,
                   n_devices, device=device, backend=backend)
    losses = res["losses"]
    print(f"dryrun_multichip OK: mesh={res['mesh']} "
          f"out_frames={res['out_frames']} voiced={res['voiced']:.2f} "
          f"fin_thr={res['fin_thr']} "
          f"train_loss={losses[0]:.3f}->{losses[-1]:.3f}", flush=True)
    return res


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     *(sys.argv[2:3] or ["cuda"]))
