"""The CUDA Viterbi kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from aegis_tpu.config import PyinConfig
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import log_transition_band
from aegis_tpu_torch.tools.signal_gen import wandering_pitch_obs

CFG = PyinConfig()
N = CFG.n_pitch_bins
LOG_STAY = float(np.log1p(-CFG.switch_prob))
LOG_SWITCH = float(np.log(CFG.switch_prob))

# (half-width, batch of (T, seed, center, step, spread, jumps)); w = 150 is
# wider than the TPU kernel's 256 Hankel rows could hold
CASES = {
    "w101": (101, [(40, 11, 200, 8, (-2, -1, 0, 1, 2), True)]),
    "w51": (51, [(32, 21, 150, 4, (0,), False)]),
    "w150_batch3": (150, [(48, 5, 220, 20, (-1, 0, 1), True),
                          (48, 6, 100, 3, (0,), True),
                          (48, 7, 400, 9, (0, 1), False)]),
    "t1": (101, [(1, 3, 200, 8, (0,), False)]),
    # a tile batch as the tiled program launches it at 44 100 Hz: six
    # haloed 1024 + 2*64 frame tiles, one CTA each
    "tiles_b6_w51": (51, [(1152, 30 + i, 100 + 50 * i, 6, (-1, 0, 1), True)
                          for i in range(6)]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_kernels_equal_plain(cuda, case):
    width, seqs = CASES[case]
    pairs = [wandering_pitch_obs(T, N, *rest) for T, *rest in seqs]
    obs = torch.from_numpy(np.stack([o for o, _ in pairs])).to(cuda)
    vprob = torch.from_numpy(np.stack([v for _, v in pairs])).to(cuda)
    lo_v = torch.log(obs + 1e-30).contiguous()
    lo_u = torch.log((1.0 - vprob) / N + 1e-30).contiguous()
    band = torch.from_numpy(log_transition_band(N, width)).to(cuda)

    before = dict(pyin_cuda.LAUNCHES)
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, N, width,
                                                 LOG_STAY, LOG_SWITCH)
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    torch.cuda.synchronize()
    assert pyin_cuda.LAUNCHES["viterbi_fwd"] == before["viterbi_fwd"] + 1
    assert pyin_cuda.LAUNCHES["viterbi_back"] == before["viterbi_back"] + 1

    p_v, p_u, p_last = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(band, N, width),
        LOG_STAY, LOG_SWITCH)
    assert torch.equal(psi_v, p_v) and torch.equal(psi_u, p_u)
    assert torch.equal(d_last, p_last)
    assert torch.equal(states, pyin_cuda.viterbi_back_plain(p_last, p_v, p_u))


@pytest.mark.cuda
def test_viterbi_kernel_rejects_what_it_cannot_take(cuda):
    band = torch.from_numpy(log_transition_band(N, 51)).to(cuda)
    lo_v = torch.zeros((1, 8, N), device=cuda)
    lo_u = torch.zeros((1, 8), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        pyin_cuda.viterbi_fwd(lo_v.double(), lo_u, band, N, 51, 0.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        pyin_cuda.viterbi_fwd(lo_v.transpose(1, 2).contiguous().transpose(1, 2),
                              lo_u, band, N, 51, 0.0, 0.0)
    with pytest.raises(ValueError, match="states"):
        wide = torch.zeros((1, 8, 600), device=cuda)
        pyin_cuda.viterbi_fwd(wide, lo_u, band, 600, 51, 0.0, 0.0)
