"""The int8 stream's device staging (``engine/turbo.py::stage_int8``): its
int8 slabs, block scales, int16 edges and edge scale are the host
staging's bit for bit (``quantize_pcm8`` and ``quantize_pcm16`` over the
zero-padded track, each slab's edges cut from the int16 copy), here on the
CPU at small slabs and, on a card, there; and the streamed program's int8
path calls no host quantizer and answers the host-staged program's rows.
Imports no JAX, so the card runs the file as it is."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig  # noqa: E402
from aegis_tpu_torch.core import analyze  # noqa: E402
from aegis_tpu_torch.core.analyze import PCM8_BLOCK  # noqa: E402
from aegis_tpu_torch.engine import turbo  # noqa: E402

F32 = np.float32
SLAB = 4 * PCM8_BLOCK  # samples a slab
CTX = 1536             # edge samples on each side of a slab


def host_stage(y: np.ndarray, n_slabs: int, slab_samp: int, ctx: int):
    """The int8 stream's host staging, as the streamed program staged
    before it quantized on the device: (slabs, block scales, edges, edge
    scale), NumPy arrays in the shapes of ``stage_int8``'s tensors."""
    y_pad = np.zeros(n_slabs * slab_samp, F32)
    y_pad[:len(y)] = np.asarray(y, F32)
    q8, bscales = analyze.quantize_pcm8(y_pad)
    y16, esc = analyze.quantize_pcm16(y_pad)
    nblk = slab_samp // PCM8_BLOCK

    def edge(s):
        lo, hi = s * slab_samp, (s + 1) * slab_samp
        left = y16[max(lo - ctx, 0): lo]
        left = np.pad(left, (ctx - len(left), 0))
        right = y16[hi: hi + ctx]
        right = np.pad(right, (0, ctx - len(right)))
        return np.concatenate([left, right])[None]

    return ([q8[None, s * slab_samp: (s + 1) * slab_samp]
             for s in range(n_slabs)],
            [bscales[None, s * nblk: (s + 1) * nblk] for s in range(n_slabs)],
            [edge(s) for s in range(n_slabs)],
            np.array([esc], F32))


def host_stage_int8(y, n_slabs, slab_samp, ctx, device):
    """``host_stage`` uploaded: a stand-in for ``turbo.stage_int8``."""
    slabs, scales, edges, esc = host_stage(y, n_slabs, slab_samp, ctx)
    return ([analyze.upload(a, device) for a in slabs],
            [analyze.upload(a, device) for a in scales],
            [analyze.upload(a, device) for a in edges],
            analyze.upload(esc, device))


def _noise(n: int, seed: int, level: float = 0.3) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, level, n).astype(F32)


def _silent_blocks() -> np.ndarray:
    y = _noise(3 * SLAB - 200, 3)
    for blk in (0, 3, 4, 9):  # the head, a slab's seam, a lone block
        y[blk * PCM8_BLOCK:(blk + 1) * PCM8_BLOCK] = 0
    y[5 * PCM8_BLOCK + 17] = 0.5  # a block silent but for one sample
    y[5 * PCM8_BLOCK:5 * PCM8_BLOCK + 17] = 0
    y[5 * PCM8_BLOCK + 18:6 * PCM8_BLOCK] = 0
    return y


def _ties() -> np.ndarray:
    """Products exactly on k + 0.5 in both quantizers: the track's peak
    1 - 2**-15 makes the int16 factor 32768 and every sample (k + 0.5) /
    32768 a tie there; blocks at peak 127 / 128 make the int8 factor 128
    and their samples (k + 0.5) / 128 ties there."""
    rng = np.random.default_rng(5)
    y = ((rng.integers(-32767, 32767, 3 * SLAB) + 0.5) / 32768).astype(F32)
    y[100] = 1 - 2.0 ** -15
    for blk in (2, 5, 8, 11):
        b = (rng.integers(-127, 127, PCM8_BLOCK) + 0.5) / 128
        b[7] = 127 / 128
        y[blk * PCM8_BLOCK:(blk + 1) * PCM8_BLOCK] = b
    assert (np.float32(32767.0 / float(np.max(np.abs(y)))) == 32768)
    return y


def _reciprocal_blocks(count: int):
    """``count`` (peak, samples) blocks where each sample times 127 / peak
    rounds to another integer than it does times 127 * (1 / peak): the
    factor that ``127.0 / tensor`` computes in PyTorch."""
    rng = np.random.default_rng(7)
    blocks = []
    while len(blocks) < count:
        p = F32(rng.uniform(0.05, 0.9))
        f1, f2 = F32(127) / p, (F32(1) / p) * F32(127)
        if f1 == f2:
            continue
        hits = []
        for k in range(127):
            b = F32((k + 0.5) / f1)
            for _ in range(4):
                if b <= p and np.round(b * f1) != np.round(b * f2):
                    hits.append(b)
                    break
                b = np.nextafter(b, F32(1), dtype=F32)
        if hits:
            blocks.append((p, np.resize(np.array(hits, F32),
                                        PCM8_BLOCK - 1)))
    return blocks


def _reciprocal() -> np.ndarray:
    y = np.zeros(2 * SLAB, F32)
    for blk, (p, b) in enumerate(_reciprocal_blocks(2 * SLAB // PCM8_BLOCK)):
        y[blk * PCM8_BLOCK] = p
        y[blk * PCM8_BLOCK + 1:(blk + 1) * PCM8_BLOCK] = b * np.where(
            np.arange(PCM8_BLOCK - 1) % 2, 1, -1)
    return y


# name -> (track, slabs, edge samples a side)
CASES = {
    "one_slab": lambda: (_noise(SLAB, 1), 1, CTX),
    "several_slabs": lambda: (_noise(3 * SLAB, 2), 3, CTX),
    "ragged": lambda: (_noise(2 * SLAB + 1500, 4), 3, CTX),
    "past_the_track": lambda: (_noise(2 * SLAB, 6), 3, CTX),
    "edges_over_slabs": lambda: (_noise(3 * SLAB + 300, 8), 4, 5000),
    "float64_track": lambda: (_noise(2 * SLAB + 77, 9).astype(np.float64)
                              * (1 + 1e-9), 3, CTX),
    "silent": lambda: (np.zeros(2 * SLAB + 700, F32), 3, CTX),
    "silent_blocks": lambda: (_silent_blocks(), 3, CTX),
    "ties": lambda: (_ties(), 3, CTX),
    "reciprocal": lambda: (_reciprocal(), 2, CTX),
}


def _assert_same(got, want):
    g_slabs, g_scales, g_edges, g_esc = got
    w_slabs, w_scales, w_edges, w_esc = want
    for g, w in zip(g_slabs + g_scales + g_edges + [g_esc],
                    w_slabs + w_scales + w_edges + [w_esc]):
        g = g.cpu().numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        assert g.tobytes() == w.tobytes()
    assert len(g_slabs) == len(w_slabs)


@pytest.mark.parametrize("case", list(CASES))
def test_the_device_staging_is_the_host_staging_bit_for_bit(case):
    """Every slab, block scale, edge and the edge scale equal the host
    staging's bytes, at one slab, several, a ragged end, a slab wholly past
    the track, edges wider than a slab, a float64 track, a silent track,
    silent blocks in a loud one, exact .5 ties, and the products that
    ``127.0 / tensor``'s reciprocal rounds to another integer."""
    y, n_slabs, ctx = CASES[case]()
    want = host_stage(y, n_slabs, SLAB, ctx)
    _assert_same(turbo.stage_int8(y, n_slabs, SLAB, ctx,
                                  torch.device("cpu")), want)
    if case == "reciprocal":
        # the case bites: the reciprocal's factor misses samples
        b = torch.from_numpy(y).reshape(-1, PCM8_BLOCK)
        peak = b.abs().amax(dim=1)
        q = torch.round(b * (127.0 / peak)[:, None]).to(torch.int8)
        assert (q.reshape(-1).numpy()
                != np.concatenate([w[0] for w in want[0]])).any()
    if case == "ties":  # half to even: every tie lands on an even integer
        assert not (np.concatenate([w[0] for w in want[2]]) % 2).any()
        q8 = np.concatenate([w[0] for w in want[0]]).reshape(-1, PCM8_BLOCK)
        assert not (np.delete(q8[[2, 5, 8, 11]], 7, axis=1) % 2).any()


@pytest.mark.cuda
def test_the_device_staging_is_the_host_staging_on_the_card():
    """Every case above, staged on the card: CUDA divides a tensor by a
    Python float as a product with its reciprocal, which the CPU does
    not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark's v1_rest_long "
                    "stages on the card")
    for case, build in CASES.items():
        y, n_slabs, ctx = build()
        _assert_same(turbo.stage_int8(y, n_slabs, SLAB, ctx,
                                      torch.device("cuda")),
                     host_stage(y, n_slabs, SLAB, ctx))


def test_the_int8_stream_calls_no_host_quantizer(monkeypatch):
    """Three slabs of two 64-frame tiles: with every host quantizer made to
    raise, the int8 stream runs, and its rows are the host-staged
    program's bit for bit, NaN f0 included."""
    audio, pyin = AudioConfig(sample_rate=22050), PyinConfig()
    y = _noise(int(4.2 * 22050), 11, 0.2)

    def stream():
        return turbo.run_analyze_streamed(
            y, audio, pyin, 0.6,
            turbo=TurboConfig(tile_frames=64, halo_frames=8), slab_tiles=2,
            fetch_mel=True, device="cpu")

    with monkeypatch.context() as m:
        m.setattr(turbo, "stage_int8", host_stage_int8)
        want = stream()

    def boom(*args, **kwargs):
        raise AssertionError("a host quantizer ran")

    for mod in (analyze, turbo):
        for name in ("quantize_pcm8", "quantize_pcm16", "quantize_tracks"):
            monkeypatch.setattr(mod, name, boom, raising=False)
    got = stream()
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key


def test_the_int16_stream_says_it_staged_on_the_host(monkeypatch):
    """``transport="int16"`` keeps the host quantizer (``quantize_tracks``):
    its stage span says ``ingest="host"`` and the device twins never run."""
    from aegis_tpu_torch.utils import prof

    def boom(*args, **kwargs):
        raise AssertionError("a device quantizer ran")

    monkeypatch.setattr(turbo, "stage_int8", boom)
    before = {s.index for s in prof.spans()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        turbo.run_analyze_streamed(
            _noise(int(2.5 * 22050), 12, 0.2), AudioConfig(sample_rate=22050),
            PyinConfig(), 0.6, turbo=TurboConfig(tile_frames=64,
                                                 halo_frames=8),
            slab_tiles=2, transport="int16", device="cpu")
    stage, = [s for s in prof.spans()
              if s.index not in before and s.name == "aegis.stream_stage"]
    assert stage.attrs == {"ingest": "host"}
