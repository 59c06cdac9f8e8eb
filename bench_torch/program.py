"""The program under test, built from a configuration's file.

Every number of ``configs/<config>.json`` that an entry point of the port
takes is handed to it: the v1 engine's rate, hop, FFT, mel bands and pYIN
grid (``audio``, ``pyin``), the chord engine's rate, window, CQT bins and
voices (``audio``, ``peel``), the ingest's transport.  A number that no
entry point takes is a constant of the port; ``refuse_unless_runs``
refuses a configuration whose number differs from the constant, so that a
run never drives the program at other numbers than the reference checks.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Iterable, Tuple


def audio_config(cfg: Dict):
    from aegis_tpu_torch.config import AudioConfig

    return AudioConfig(**cfg["audio"])


def pyin_config(cfg: Dict):
    from aegis_tpu_torch.config import PyinConfig

    return PyinConfig(**cfg["pyin"])


def _default(fn, name: str):
    return inspect.signature(fn).parameters[name].default


def fixed_numbers(cfg: Dict) -> Iterable[Tuple[str, object, object]]:
    """(key, the configuration's number, the port's constant) for each
    number of ``cfg`` that no entry point takes."""
    from aegis_tpu_torch.core import analyze

    ing = cfg.get("ingest")
    if ing:
        yield "ingest.block", ing["block"], analyze.PCM8_BLOCK
        yield "ingest.int4_block", ing["int4_block"], analyze.PCM4_BLOCK
        yield "ingest.min_bucket", ing["min_bucket"], analyze.MIN_BUCKET
    if "pyin" in cfg:
        yield ("ingest.transport", ing["transport"],
               _default(analyze.run_analyze, "transport"))
    peel = cfg.get("peel")
    if peel:
        from aegis_tpu_torch.core import cqt, poly
        from aegis_tpu_torch.engine import poly as poly_engine_mod

        yield "audio.n_mels", cfg["audio"]["n_mels"], poly_engine_mod.N_MELS
        yield "peel.fmin_midi", peel["fmin_midi"], cqt.CQT_FMIN_MIDI
        yield ("peel.comb_norm_floor", peel["comb_norm_floor"],
               poly.COMB_NORM_FLOOR)
        for key in ("n_harmonics", "decay", "spread"):
            yield (f"peel.{key}", peel[key],
                   _default(poly.harmonic_subtraction_matrix, key))
        for key in ("over_subtract", "alpha", "gamma19", "gamma12"):
            yield f"peel.{key}", peel[key], _default(poly.peel_voices, key)


def refuse_unless_runs(cfg: Dict, extra: Iterable[Tuple[str, object, object]]
                       = ()) -> None:
    """Raise, naming each, where a number of ``cfg`` that the program
    cannot be given differs from what the program runs."""
    off = [f"{key} {mine!r} (the program runs {theirs!r})"
           for key, mine, theirs in (*fixed_numbers(cfg), *extra)
           if mine != theirs]
    if off:
        raise ValueError(f"configuration {cfg.get('name')!r} asks for what "
                         "the program cannot be given: " + "; ".join(off))


def differing_fields(mine, theirs, prefix: str):
    """(key, mine, theirs) for each field of two config dataclasses: the
    configuration's and what an entry point runs."""
    for f in dataclasses.fields(mine):
        yield (f"{prefix}.{f.name}", getattr(mine, f.name),
               getattr(theirs, f.name))


def v1_engine(cfg: Dict, device):
    """``AegisEngine`` at the configuration's audio and pYIN numbers."""
    from aegis_tpu_torch.engine.engine import AegisEngine

    a = cfg["audio"]
    eng = AegisEngine(sample_rate=a["sample_rate"],
                      hop_length=a["hop_length"], n_fft=a["n_fft"],
                      device=device)
    eng.audio = audio_config(cfg)
    eng.pyin_cfg = pyin_config(cfg)
    return eng


def poly_engine(cfg: Dict, device):
    """``AegisPolyEngine`` at the configuration's audio and peel numbers."""
    from aegis_tpu_torch.engine.poly import AegisPolyEngine

    a, p = cfg["audio"], cfg["peel"]
    return AegisPolyEngine(sample_rate=a["sample_rate"],
                           hop_length=a["hop_length"], n_fft=a["n_fft"],
                           n_bins=p["n_bins"],
                           bins_per_octave=p["bins_per_octave"],
                           max_voices=p["max_voices"],
                           transport=cfg["ingest"]["transport"],
                           device=device)


def server(cfg: Dict, device, temp_dir: str):
    """``AegisServer`` around the configuration's engines: the v1 engine
    where it has a pYIN grid (else the server's own at its rate), and the
    chord engine where it has a peel, in place of the server's lazy one."""
    from aegis_tpu_torch.engine.engine import AegisEngine
    from aegis_tpu_torch.serve.server import AegisServer

    refuse_unless_runs(cfg)
    if "pyin" in cfg:
        eng = v1_engine(cfg, device)
    else:
        eng = AegisEngine(sample_rate=cfg["audio"]["sample_rate"],
                          device=device)
    srv = AegisServer(engine=eng, temp_dir=temp_dir)
    if "peel" in cfg:
        srv._poly_engine = poly_engine(cfg, device)
    return srv

