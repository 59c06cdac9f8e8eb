"""Folder batch sweep (PyTorch): every matching audio file of a folder to
MIDI, on one device or over a mesh of ranks.

Counterpart of ``aegis_tpu/engine/poly.py::transcribe_folder`` (also
importable from ``engine.poly``).  On one device every track's fused
analyze is queued on the device at
the track's OWN length bucket (``core.analyze.dispatch_analyze``, which
does not wait for the device) before any result is fetched, so track i+1's
upload and compute overlap track i's fetch; event extraction and the MIDI
encode then run per track on the host.  The engines are "v1" and
"financial" with the pYIN backend and "poly" (chord-capable CQT salience
peeling through ``engine.poly``) and "auto" (the polyphony-aware router,
``engine.auto``), each dispatched ahead the same way; "v1" and "financial"
also with the neural backend (PitchNet,
``models.pitchnet.dispatch_analyze_neural``).  On a ``utils/mesh.py`` mesh
of ranks (or, with no mesh, in an initialized ``torch.distributed`` world)
the tracks are zero-padded to the longest, stacked and run as one sharded
batch, as the JAX package runs them on a device mesh.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.io.audio import load_audio
from aegis_tpu_torch.midi.encode import events_to_midi, events_to_midi_financial
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.core.analyze import (check_transport, dispatch_analyze,
                                          fetch_analyze)
from aegis_tpu_torch.core.events import extract_events_v1
from aegis_tpu_torch.utils.mesh import Mesh, rank_device
from aegis_tpu_torch.utils.prof import phase

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
    mesh: Optional[Mesh] = None,
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

    ``turbo`` tiles the sharded batch; the one-device path runs the fused
    program and does not tile.  ``transport`` is the upload packing of
    ``core.analyze.run_analyze`` (int8 | int4 | int16 | float32); the
    neural backend takes int8 | int16 | float32, and the poly and auto
    engines keep their own int8 block-float.

    With a ``mesh`` (or, with none, in an initialized world: every rank,
    the JAX package's default) the tracks are zero-padded to the longest,
    stacked and analyzed as one sharded batch: "v1" / "financial" through
    engine.turbo.run_analyze_batch (per-track int16, or float32 when asked
    for), "poly" through run_analyze_poly_turbo, the neural backend at
    22 050 Hz through models.pitchnet.run_analyze_neural_batch (other rates
    dispatch per track), "auto" per track (it has no sharded program, and
    says so).  Every rank extracts the events and returns the same list;
    rank 0 alone writes the MIDI files.
    """
    if engine not in ("v1", "financial", "poly", "auto"):
        raise ValueError(f"unknown engine: {engine!r} "
                         "(v1 | financial | poly | auto)")
    if engine in ("poly", "auto") and pitch_backend != "pyin":
        raise ValueError("the polyphonic/routed engines embed their own "
                         "pitch stacks (no neural backend)")
    if pitch_backend not in ("pyin", "neural"):
        raise ValueError(f"unknown pitch backend: {pitch_backend!r}")
    check_transport(transport)
    single_chip = mesh is None and not dist.is_initialized()
    device = rank_device(mesh, device)
    lead = (mesh.rank if mesh is not None
            else dist.get_rank() if not single_chip else 0) == 0

    paths = sorted(glob.glob(os.path.join(folder, pattern)))
    if not paths:
        return []
    output_dir = output_dir or folder
    os.makedirs(output_dir, exist_ok=True)

    duration = (end_time - start_time) if end_time else None
    tracks = []
    for i, p in enumerate(paths):
        with phase("folder.load", track=i):
            tracks.append(load_audio(p, sr=sample_rate, offset=start_time,
                                     duration=duration)[0])
    lengths = [len(y) for y in tracks]

    audio = AudioConfig(sample_rate=sample_rate)
    pyin_cfg = PyinConfig()
    rake_sensitivity = extract_kwargs.pop("rake_sensitivity", 0.6)
    financial = engine == "financial"
    log.info(f"Folder batch [{engine}, {device}]: {len(paths)} tracks x "
             f"{max(len(y) for y in tracks) / sample_rate:.1f}s max")

    def mid_path_of(p: str) -> str:
        return os.path.join(output_dir,
                            os.path.splitext(os.path.basename(p))[0] + ".mid")

    def dispatch_ahead(dispatch, fetch) -> list:
        """Every track queued on the device before any is fetched; each
        track's spans carry its index in the pass (``track``)."""
        handles = []
        for i, y in enumerate(tracks):
            with phase("aegis.enqueue", track=i):
                handles.append(dispatch(y))
        out = []
        for i, h in enumerate(handles):
            with phase("aegis.fetch", track=i):
                out.append(fetch(h))
        return out

    def stacked() -> np.ndarray:
        """The tracks zero-padded to the longest, as one (B, n) batch."""
        n = max(lengths)
        return np.stack([np.pad(y, (0, n - len(y))) for y in tracks])

    def mesh_slices(out) -> list:
        """Sharded batch output -> per-track dicts, each cut to its own
        frames (per-track scalars such as adaptive_threshold pass through
        unsliced)."""
        def cut(v, i, tf):
            a = np.asarray(v[i])
            return a[:tf] if a.ndim >= 1 else a
        return [{k: cut(v, i, audio.n_frames(lengths[i]))
                 for k, v in out.items()} for i in range(len(tracks))]

    if engine == "auto":
        from aegis_tpu_torch.engine.auto import (AegisAutoEngine,
                                                 dispatch_analyze_auto,
                                                 fetch_analyze_auto)

        if not single_chip:
            log.info("auto engine has no sharded batch path; running "
                     "dispatch-ahead on the default device")
        aeng = AegisAutoEngine(sample_rate=sample_rate, device=device)
        per_track = dispatch_ahead(
            lambda y: dispatch_analyze_auto(y, aeng, rake_sensitivity,
                                            device=device),
            lambda h: fetch_analyze_auto(h, aeng))
        results = []
        for i, (p, r) in enumerate(zip(paths, per_track)):
            mid_path = mid_path_of(p)
            with phase("folder.extract", track=i):
                events = aeng.extract_events(
                    r, output_mid=mid_path if lead else None,
                    **extract_kwargs)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    if engine == "poly":
        from aegis_tpu_torch.engine.poly import (AegisPolyEngine,
                                                 dispatch_analyze_poly,
                                                 fetch_analyze_poly)

        peng = AegisPolyEngine(sample_rate=sample_rate, device=device)
        if single_chip:
            per_track = dispatch_ahead(
                lambda y: dispatch_analyze_poly(
                    y, sample_rate, peng.n_fft, peng.hop_length, peng.n_bins,
                    peng.bins_per_octave, peng.max_voices,
                    transport=peng.transport, device=device),
                fetch_analyze_poly)
        else:
            from aegis_tpu_torch.engine.turbo import run_analyze_poly_turbo

            out = run_analyze_poly_turbo(
                stacked(), sr=sample_rate, n_fft=peng.n_fft,
                hop_length=peng.hop_length, n_bins=peng.n_bins,
                bins_per_octave=peng.bins_per_octave,
                max_voices=peng.max_voices, turbo=turbo, device=device,
                mesh=mesh)
            # poly frame grid: 1 + n // hop (sr-proportional hop)
            per_track = [
                {k: np.asarray(v[i])[: 1 + lengths[i] // peng.hop_length]
                 for k, v in out.items()} for i in range(len(tracks))]
        results = []
        for i, (p, r) in enumerate(zip(paths, per_track)):
            mid_path = mid_path_of(p)
            with phase("folder.extract", track=i):
                events = peng.extract_events(r, output_mid=mid_path if lead
                                             else None, **extract_kwargs)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    if pitch_backend == "neural":
        from aegis_tpu_torch.models.pitchnet import (SR_NATIVE,
                                                     default_params,
                                                     dispatch_analyze_neural,
                                                     fetch_analyze_neural,
                                                     run_analyze_neural_batch)

        params = default_params(device)
        if not single_chip and sample_rate == SR_NATIVE:
            # ONE data-parallel batch over the ranks; the net replicates
            per_track = mesh_slices(run_analyze_neural_batch(
                stacked(), sample_rate, audio.hop_length, params,
                rake_sensitivity, n_fft=audio.n_fft, n_mels=audio.n_mels,
                financial=financial, device=device, mesh=mesh))
        else:
            per_track = dispatch_ahead(
                lambda y: dispatch_analyze_neural(
                    y, sample_rate, audio.hop_length, params,
                    rake_sensitivity, n_fft=audio.n_fft, n_mels=audio.n_mels,
                    fetch_mel=False, financial=financial,
                    transport=transport, device=device),
                fetch_analyze_neural)
        # PitchNet fires up to ~a window early; forward-snap such starts to
        # the attack rise (the v1 facade's backend convention; the
        # financial facade reads the pitch_backend marker below)
        if not financial:
            extract_kwargs.setdefault("onset_fwd_snap_ms", 100.0)
    elif single_chip:
        per_track = dispatch_ahead(
            lambda y: dispatch_analyze(y, audio, pyin_cfg, rake_sensitivity,
                                       financial=financial, fetch_mel=False,
                                       transport=transport, device=device),
            fetch_analyze)
    else:
        from aegis_tpu_torch.engine.turbo import (TILED_TRANSPORTS,
                                                  run_analyze_batch)

        per_track = mesh_slices(run_analyze_batch(
            stacked(), audio, pyin_cfg, rake_sensitivity, turbo=turbo,
            fetch_mel=False, financial=financial,
            transport=transport if transport in TILED_TRANSPORTS else "int16",
            device=device, mesh=mesh))

    results = []
    if financial:
        from aegis_tpu_torch.engine.financial import AegisFinancialEngine

        feng = AegisFinancialEngine(sample_rate=sample_rate,
                                    hop_length=audio.hop_length,
                                    n_fft=audio.n_fft, device=device)
        for i, (p, r) in enumerate(zip(paths, per_track)):
            # the facade's backend marker (the neural forward onset snap)
            r["pitch_backend"] = pitch_backend
            mid_path = mid_path_of(p)
            with phase("folder.extract", track=i):
                events, info = feng.extract_events(r, **extract_kwargs)
                if lead:
                    events_to_midi_financial(events, sample_rate,
                                             audio.hop_length,
                                             bpm=info.get("bpm"),
                                             output=mid_path)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    # onset refinement on by default, the library default;
    # use_onsets=False restores the reference's merge/lag semantics
    use_onsets = extract_kwargs.pop("use_onsets", True)
    for i, (p, r) in enumerate(zip(paths, per_track)):
        mid_path = mid_path_of(p)
        with phase("folder.extract", track=i):
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
            if lead:
                events_to_midi(events, sample_rate, audio.hop_length,
                               output=mid_path)
        results.append((p, mid_path, len(events)))
        log.info(f"  {os.path.basename(p)}: {len(events)} events")
    return results
