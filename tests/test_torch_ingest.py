"""The one ingest (``core/analyze.py::ingest``) and a live session that
keeps its tile program.

On the CPU: every transport's staged samples and scale are its
quantizer's, bitwise, the scale a float32 tensor (rank 1 for the block
transports, 0-d for int16 and float32) that ``dequant_transport`` reads
as a plain NumPy dequantization of the quantizer's output does; every
entry point that takes a ``transport`` runs on the names it accepts and
raises the one error, naming them, on any other; nine live sessions at
nine sample rates, fed in turn past the tile-program cache's eight, build
one program each.  On the card (marker ``cuda``): the same sessions
capture one graph each.

The file imports no jax, so on a machine with a card and no JAX it runs
alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ingest.py
"""

import re

import numpy as np
import pytest
import torch

from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import analyze
from aegis_tpu_torch.engine import realtime
from aegis_tpu_torch.engine.folder import transcribe_folder
from aegis_tpu_torch.engine.poly import dispatch_analyze_poly
from aegis_tpu_torch.engine.turbo import run_analyze_batch
from aegis_tpu_torch.io.wav import write_wav
from aegis_tpu_torch.models.pitchnet import dispatch_analyze_neural
from aegis_tpu_torch.tools.signal_gen import generate_test_track

# One torch thread per process: the suite runs in parallel pytest workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SR = 22050
AUDIO = AudioConfig(sample_rate=SR)
CFG = PyinConfig()

ALL = ("int8", "int4", "int16", "float32")
# the public entry points and the transports each takes
ACCEPTS = {
    "dispatch_analyze": ALL,
    "transcribe_folder": ALL,
    "dispatch_analyze_poly": ("int8", "int16"),
    "dispatch_analyze_neural": ("int8", "int16", "float32"),
    "run_analyze_batch": ("int16", "float32"),
}
# the sample rates of the live sessions: one more than the tile-program
# cache holds
RATES = (11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000)


@pytest.fixture(scope="module")
def clip():
    """The canonical test track (two rakes among three notes), 22 050 Hz."""
    return np.asarray(generate_test_track(sr=SR)[0], np.float32)


def _dequant(transport, q, scale) -> np.ndarray:
    """The quantizer's output dequantized in NumPy."""
    q = np.asarray(q)
    if transport == "int4":
        lo = (q & 0xF).astype(np.int8)
        hi = (q >> 4).astype(np.int8)
        q = np.stack([np.where(lo >= 8, lo - 16, lo),
                      np.where(hi >= 8, hi - 16, hi)], axis=-1).reshape(-1)
    q = q.astype(np.float32)
    if np.ndim(scale):
        return (q.reshape(len(scale), -1) * scale[:, None]).reshape(-1)
    return q * np.float32(scale)


@pytest.mark.parametrize("length", ["bucket", "ragged"])
@pytest.mark.parametrize("transport", ALL)
def test_the_ingest_is_the_quantizer_bitwise(clip, transport, length):
    """A bucket-padded take, and a ragged one (the neural dispatch's
    resampled take), which a block transport pads to its block."""
    assert analyze.TRANSPORTS == ALL
    y = (analyze.pad_to_bucket(clip) if length == "bucket"
         else clip[:len(clip) // 3 * 2 + 1])
    quantize, block = {"int8": (analyze.quantize_pcm8, analyze.PCM8_BLOCK),
                       "int4": (analyze.quantize_pcm4, analyze.PCM4_BLOCK),
                       "int16": (analyze.quantize_pcm16, 1),
                       "float32": (lambda a: (a, 1.0), 1)}[transport]
    want_q, want_s = quantize(np.pad(y, (0, -len(y) % block)))
    samples, scale = staged = analyze.ingest(y, transport, CPU)
    assert staged.upload(CPU) is staged
    assert samples.numpy().dtype == want_q.dtype
    assert samples.numpy().tobytes() == want_q.tobytes()
    assert scale.dtype == torch.float32
    assert scale.dim() == (1 if transport in ("int8", "int4") else 0)
    assert (scale.numpy().tobytes()
            == np.asarray(want_s, np.float32).tobytes())
    got = analyze.dequant_transport(samples, scale).numpy()
    assert got.tobytes() == _dequant(transport, want_q, want_s).tobytes()


def _enter(entry, transport, y, folder):
    if entry == "dispatch_analyze":
        analyze.fetch_analyze(analyze.dispatch_analyze(
            y, AUDIO, CFG, transport=transport, device="cpu"))
    elif entry == "dispatch_analyze_poly":
        dispatch_analyze_poly(y, SR, transport=transport, device="cpu")
    elif entry == "dispatch_analyze_neural":
        dispatch_analyze_neural(y, SR, AUDIO.hop_length,
                                transport=transport, device="cpu")
    elif entry == "run_analyze_batch":
        run_analyze_batch(y[None], AUDIO, CFG, transport=transport,
                          device="cpu")
    else:
        write_wav(str(folder / "take.wav"), y, SR)
        assert len(transcribe_folder(str(folder), sample_rate=SR,
                                     transport=transport, device="cpu")) == 1


@pytest.mark.parametrize("transport", ALL + ("int12",))
@pytest.mark.parametrize("entry", sorted(ACCEPTS))
def test_each_entry_point_takes_its_transports(clip, tmp_path, entry,
                                               transport):
    y = clip[:SR]
    accepted = ACCEPTS[entry]
    if transport in accepted:
        _enter(entry, transport, y, tmp_path)
        return
    error = f"unknown transport '{transport}' ({' | '.join(accepted)})"
    with pytest.raises(ValueError, match=f"^{re.escape(error)}$"):
        _enter(entry, transport, y, tmp_path)


def _nine_sessions(device, monkeypatch) -> list:
    """Nine sessions at nine rates fed in turn, two tiles each: the
    programs built while they ran, and the sessions."""
    built = []
    init = realtime._TileProgram.__init__

    def counted(self, *args):
        built.append(self)
        init(self, *args)

    monkeypatch.setattr(realtime._TileProgram, "__init__", counted)
    realtime._tile_program.cache_clear()
    sessions = [realtime.StreamingTranscriber(
        audio=AudioConfig(sample_rate=sr), device=device) for sr in RATES]
    rng = np.random.default_rng(7)
    for _ in range(3):
        for rt in sessions:
            rt.feed(0.1 * rng.standard_normal(rt._tile_samp, np.float32))
    assert [rt.frames_analyzed for rt in sessions] == [48] * len(RATES)
    return built, sessions


def test_a_live_session_keeps_its_tile_program(monkeypatch):
    """More keys than the cache holds, fed tile by tile in turn, evict
    every program between two tiles of its session; each session still
    builds its program once, at its first tile (was: once a tile)."""
    assert realtime._tile_program.cache_info().maxsize < len(RATES)
    built, sessions = _nine_sessions(CPU, monkeypatch)
    assert len(built) == len(RATES)
    assert [rt._program for rt in sessions] == built
    assert realtime._tile_program.cache_info().currsize == 8


@pytest.mark.cuda
def test_a_live_session_captures_its_graph_once(monkeypatch):
    """The same sessions on the card: one capture a session."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these on the "
                    "card")
    captured = []
    init = realtime._LiveGraph.__init__

    def counted(self, *args):
        captured.append(self)
        init(self, *args)

    monkeypatch.setattr(realtime._LiveGraph, "__init__", counted)
    built, sessions = _nine_sessions(torch.device("cuda"), monkeypatch)
    assert len(built) == len(captured) == len(RATES)
    assert [rt._program._graph for rt in sessions] == captured
