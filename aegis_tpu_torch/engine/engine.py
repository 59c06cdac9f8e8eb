"""AegisEngine — the v1 two-phase engine facade (PyTorch).

Counterpart of ``aegis_tpu/engine/engine.py``, fused pYIN path only:

  * ``audio_to_midi(input_wav, output_mid=None, **kw) -> raw_data`` — the
    cacheable Perception Phase, one ``core.analyze.run_analyze`` on the
    engine's device;
  * ``extract_events(raw_data, output_mid, **kw) -> events`` — the
    re-runnable event extraction and MIDI encode.

raw_data keeps the JAX engine's schema: {rake_mask, f0, voiced_flag,
voiced_probs, rms, y, onset_env, mel_db, pitch_backend}, f0 zero-filled on
unvoiced frames.

There is no fallback: a device failure raises, and the tiled/streamed
turbo modes and the neural pitch backend raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.io.audio import load_audio as _load_audio
from aegis_tpu.midi.encode import events_to_midi
from aegis_tpu.utils.logging import get_logger
from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.core.analyze import run_analyze
from aegis_tpu_torch.core.events import extract_events_v1

log = get_logger("Aegis")


def _require_fused(mode, n_samples: int, sample_rate: int,
                   stream_threshold_s: float = 240.0) -> None:
    """The JAX engine's turbo vocabulary (normalize_turbo_mode), of which
    only the fused single program is ported: False | None | "" | "off",
    and "auto" up to stream_threshold_s, pass; the tiled and streamed
    modes raise NotImplementedError; unknown values raise ValueError."""
    if mode in (False, None, "", "off"):
        return
    if mode == "auto" and n_samples / sample_rate <= stream_threshold_s:
        return
    if mode in (True, "tiles", "turbo", "stream", "auto"):
        raise NotImplementedError(
            f"turbo_mode={mode!r}: only the fused program is ported")
    raise ValueError(f"unknown turbo mode: {mode!r}")


class AegisEngine:
    def __init__(self, sample_rate: int = 44100, hop_length: int = 512,
                 n_fft: int = 2048, device="cuda"):
        """device: "cuda" (the default; raises when no GPU is available)
        or "cpu" (the plain versions of every kernel)."""
        self.audio = AudioConfig(sample_rate=sample_rate, hop_length=hop_length,
                                 n_fft=n_fft)
        self.pyin_cfg = PyinConfig()
        self.device = resolve_device(device)

    @property
    def sr(self) -> int:
        return self.audio.sample_rate

    @property
    def hop_length(self) -> int:
        return self.audio.hop_length

    # -------------------------------------------------------------- phase one

    def audio_to_midi(self, input_wav: Union[str, bytes, np.ndarray],
                      output_mid=None, **kwargs) -> Optional[Dict]:
        """Perception Phase (analyze once): returns the cacheable raw_data."""
        start_time = kwargs.get("start_time", 0)
        end_time = kwargs.get("end_time", None)
        rake_sensitivity = kwargs.get("rake_sensitivity", 0.6)
        pitch_backend = kwargs.get("pitch_backend", "pyin")
        if pitch_backend != "pyin":
            raise NotImplementedError(
                f"pitch_backend={pitch_backend!r}: only pyin is ported")

        if isinstance(input_wav, np.ndarray):
            y = input_wav.astype(np.float32)
        else:
            duration = (end_time - start_time) if end_time else None
            y, _ = _load_audio(input_wav, sr=self.sr, offset=start_time,
                               duration=duration)
        if len(y) == 0:
            return None
        _require_fused(kwargs.get("turbo_mode", False), len(y), self.sr,
                       kwargs.get("stream_threshold_s", 240.0))

        log.info(f"Perception Phase ({self.device}, {len(y)/self.sr:.1f}s)")
        with torch.profiler.record_function("aegis.perception"):
            out = run_analyze(y, self.audio, self.pyin_cfg, rake_sensitivity,
                              fetch_mel=kwargs.get("fetch_mel", True),
                              device=self.device)

        raw = {
            "rake_mask": np.asarray(out["rake_mask"]),
            "f0": np.nan_to_num(np.asarray(out["f0"], dtype=np.float64)),
            "voiced_flag": np.asarray(out["voiced_flag"]),
            "voiced_probs": np.asarray(out["voiced_probs"], dtype=np.float64),
            "rms": np.asarray(out["rms"], dtype=np.float64),
            "y": y,
            "onset_env": np.asarray(out["onset_env"], dtype=np.float64),
        }
        if "mel_db" in out:
            raw["mel_db"] = np.asarray(out["mel_db"])
        raw["pitch_backend"] = pitch_backend
        if output_mid is not None:
            self.extract_events(raw, output_mid, **kwargs)
        return raw

    # -------------------------------------------------------------- phase two

    def extract_events(self, raw_data: Dict, output_mid=None,
                       **kwargs) -> List[dict]:
        """Logic Filter Layer: fast re-runnable event extraction + MIDI encode."""
        with torch.profiler.record_function("aegis.extract"):
            events = extract_events_v1(
                rake_mask=raw_data["rake_mask"],
                f0=raw_data["f0"],
                voiced_flag=raw_data["voiced_flag"],
                active_probs=raw_data["voiced_probs"],
                rms=raw_data["rms"],
                sr=self.sr,
                hop_length=self.hop_length,
                confidence_threshold=kwargs.get("confidence_threshold", 0.70),
                noise_gate_db=kwargs.get("noise_gate_db", -40),
                sustain_ms=kwargs.get("sustain_ms", 50),
                min_note_duration_ms=kwargs.get("min_note_duration_ms", 50),
                # onset refinement (re-attack splitting + attack-time snap)
                # is the library default; use_onsets=False restores the
                # reference's exact merge/lag semantics
                onset_env=raw_data.get("onset_env")
                if kwargs.get("use_onsets", True) else None,
                onset_fwd_snap_ms=kwargs.get("onset_fwd_snap_ms", 0.0),
            )
            if output_mid is not None:
                bpm = kwargs.get("bpm")
                if bpm == "auto":
                    bpm = self.estimate_bpm(raw_data)
                events_to_midi(
                    events,
                    self.sr,
                    self.hop_length,
                    midi_program=kwargs.get("midi_program", 27),
                    vibrato_rate=kwargs.get("vibrato_rate", 5.0),
                    vibrato_depth=kwargs.get("vibrato_depth", 0.3),
                    bpm=bpm,
                    output=output_mid,
                )
        return events

    def estimate_bpm(self, raw_data: Dict):
        """Tempo estimate from the analysis onset envelope (None when the
        track carries no periodicity)."""
        from aegis_tpu.core.tempo import estimate_bpm

        return estimate_bpm(raw_data, self.sr, self.hop_length)

    # ------------------------------------------------------------ persistence

    @staticmethod
    def save_raw(raw_data: Dict, path: str) -> None:
        np.savez_compressed(path, **raw_data)

    @staticmethod
    def load_raw(path: str) -> Dict:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
