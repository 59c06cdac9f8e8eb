"""Folder batch sweep (PyTorch): every matching audio file of a folder to
MIDI on one device.

Counterpart of ``aegis_tpu/engine/poly.py::transcribe_folder``, its
one-device branch: every track's fused analyze is queued on the device at
the track's OWN length bucket (``core.analyze.dispatch_analyze``, which
does not wait for the device) before any result is fetched, so track i+1's
upload and compute overlap track i's fetch; event extraction and the MIDI
encode then run per track on the host.  The engines are "v1" and
"financial" with the pYIN backend and "poly" (chord-capable CQT salience
peeling through ``engine.poly``) and "auto" (the polyphony-aware router,
``engine.auto``), each dispatched ahead the same way; "v1" and "financial"
also with the neural backend (PitchNet,
``models.pitchnet.dispatch_analyze_neural``).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.io.audio import load_audio
from aegis_tpu_torch.midi.encode import events_to_midi, events_to_midi_financial
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.core.analyze import dispatch_analyze, fetch_analyze
from aegis_tpu_torch.core.events import extract_events_v1

log = get_logger("Folder")


def transcribe_folder(
    folder: str,
    output_dir: Optional[str] = None,
    pattern: str = "*.wav",
    sample_rate: int = 22050,
    start_time: float = 0.0,
    end_time: Optional[float] = None,
    turbo: Optional[TurboConfig] = None,
    pitch_backend: str = "pyin",
    engine: str = "v1",
    transport: str = "int8",
    device="cuda",
    **extract_kwargs,
) -> List[Tuple[str, str, int]]:
    """Batch-transcribe every file of ``folder`` matching ``pattern``.

    Tracks are loaded over [start_time, end_time), dispatched one fused
    program each (no common-length padding: a 5 s clip beside a 60 s track
    costs a 5 s upload), fetched, and extracted with the per-track
    facade's defaults: "v1" as ``AegisEngine.extract_events``'s extractor,
    "financial" through ``AegisFinancialEngine.extract_events``, "poly"
    through ``AegisPolyEngine.extract_events`` (the poly engine keeps its
    own transport), so folder events equal the facades'.  Returns
    [(wav_path, mid_path, n_events)].

    ``turbo`` is accepted for the JAX signature; the one-device path runs
    the fused program and does not tile.  ``transport`` is the upload
    packing of ``core.analyze.run_analyze`` (int8 | int4 | int16 |
    float32); the neural backend takes int8 | int16 | float32, and the poly
    and auto engines keep their own int8 block-float.
    """
    if engine not in ("v1", "financial", "poly", "auto"):
        raise ValueError(f"unknown engine: {engine!r} "
                         "(v1 | financial | poly | auto)")
    if engine in ("poly", "auto") and pitch_backend != "pyin":
        raise ValueError("the polyphonic/routed engines embed their own "
                         "pitch stacks (no neural backend)")
    if pitch_backend not in ("pyin", "neural"):
        raise ValueError(f"unknown pitch backend: {pitch_backend!r}")
    if transport not in ("int8", "int4", "int16", "float32"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(int8 | int4 | int16 | float32)")
    device = resolve_device(device)

    paths = sorted(glob.glob(os.path.join(folder, pattern)))
    if not paths:
        return []
    output_dir = output_dir or folder
    os.makedirs(output_dir, exist_ok=True)

    duration = (end_time - start_time) if end_time else None
    tracks = [load_audio(p, sr=sample_rate, offset=start_time,
                         duration=duration)[0] for p in paths]

    audio = AudioConfig(sample_rate=sample_rate)
    pyin_cfg = PyinConfig()
    rake_sensitivity = extract_kwargs.pop("rake_sensitivity", 0.6)
    financial = engine == "financial"
    log.info(f"Folder batch [{engine}, {device}]: {len(paths)} tracks x "
             f"{max(len(y) for y in tracks) / sample_rate:.1f}s max")

    def mid_path_of(p: str) -> str:
        return os.path.join(output_dir,
                            os.path.splitext(os.path.basename(p))[0] + ".mid")

    if engine == "auto":
        from aegis_tpu_torch.engine.auto import (AegisAutoEngine,
                                                 dispatch_analyze_auto,
                                                 fetch_analyze_auto)

        aeng = AegisAutoEngine(sample_rate=sample_rate, device=device)
        handles = [dispatch_analyze_auto(y, aeng, rake_sensitivity,
                                         device=device) for y in tracks]
        results = []
        for p, h in zip(paths, handles):
            mid_path = mid_path_of(p)
            events = aeng.extract_events(fetch_analyze_auto(h, aeng),
                                         output_mid=mid_path,
                                         **extract_kwargs)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    if engine == "poly":
        from aegis_tpu_torch.engine.poly import (AegisPolyEngine,
                                                 dispatch_analyze_poly,
                                                 fetch_analyze_poly)

        peng = AegisPolyEngine(sample_rate=sample_rate, device=device)
        handles = [dispatch_analyze_poly(
            y, sample_rate, peng.n_fft, peng.hop_length, peng.n_bins,
            peng.bins_per_octave, peng.max_voices,
            transport=peng.transport, device=device) for y in tracks]
        results = []
        for p, h in zip(paths, handles):
            mid_path = mid_path_of(p)
            events = peng.extract_events(fetch_analyze_poly(h),
                                         output_mid=mid_path,
                                         **extract_kwargs)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    if pitch_backend == "neural":
        from aegis_tpu_torch.models.pitchnet import (default_params,
                                                     dispatch_analyze_neural,
                                                     fetch_analyze_neural)

        params = default_params(device)
        handles = [dispatch_analyze_neural(
            y, sample_rate, audio.hop_length, params, rake_sensitivity,
            n_fft=audio.n_fft, n_mels=audio.n_mels, fetch_mel=False,
            financial=financial, transport=transport, device=device)
            for y in tracks]
        per_track = [fetch_analyze_neural(h) for h in handles]
        # PitchNet fires up to ~a window early; forward-snap such starts to
        # the attack rise (the v1 facade's backend convention; the
        # financial facade reads the pitch_backend marker below)
        if not financial:
            extract_kwargs.setdefault("onset_fwd_snap_ms", 100.0)
    else:
        handles = [dispatch_analyze(y, audio, pyin_cfg, rake_sensitivity,
                                    financial=financial, fetch_mel=False,
                                    transport=transport, device=device)
                   for y in tracks]
        per_track = [fetch_analyze(h) for h in handles]

    results = []
    if financial:
        from aegis_tpu_torch.engine.financial import AegisFinancialEngine

        feng = AegisFinancialEngine(sample_rate=sample_rate,
                                    hop_length=audio.hop_length,
                                    n_fft=audio.n_fft, device=device)
        for p, r in zip(paths, per_track):
            # the facade's backend marker (the neural forward onset snap)
            r["pitch_backend"] = pitch_backend
            events, info = feng.extract_events(r, **extract_kwargs)
            mid_path = mid_path_of(p)
            events_to_midi_financial(events, sample_rate, audio.hop_length,
                                     bpm=info.get("bpm"), output=mid_path)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    # onset refinement on by default, the library default;
    # use_onsets=False restores the reference's merge/lag semantics
    use_onsets = extract_kwargs.pop("use_onsets", True)
    for p, r in zip(paths, per_track):
        events = extract_events_v1(
            rake_mask=r["rake_mask"],
            f0=np.nan_to_num(np.asarray(r["f0"], np.float64)),
            voiced_flag=r["voiced_flag"],
            active_probs=np.asarray(r["voiced_probs"], np.float64),
            rms=np.asarray(r["rms"], np.float64),
            sr=sample_rate, hop_length=audio.hop_length,
            onset_env=(np.asarray(r["onset_env"], np.float64)
                       if use_onsets else None),
            **extract_kwargs,
        )
        mid_path = mid_path_of(p)
        events_to_midi(events, sample_rate, audio.hop_length, output=mid_path)
        results.append((p, mid_path, len(events)))
        log.info(f"  {os.path.basename(p)}: {len(events)} events")
    return results
