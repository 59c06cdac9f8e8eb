"""AegisEngine — the v1 two-phase engine facade (PyTorch).

Counterpart of ``aegis_tpu/engine/engine.py`` with the pYIN backend:

  * ``audio_to_midi(input_wav, output_mid=None, **kw) -> raw_data`` — the
    cacheable Perception Phase on the engine's device: the fused program
    (``core.analyze.run_analyze``), the tiled program
    (``engine.turbo.run_analyze_turbo``) or bounded-memory slabs
    (``engine.turbo.run_analyze_streamed``), chosen by ``turbo_mode``
    through ``normalize_turbo_mode``;
  * ``extract_events(raw_data, output_mid, **kw) -> events`` — the
    re-runnable event extraction and MIDI encode.

``pitch_backend="neural"`` swaps pYIN for PitchNet (``models.pitchnet``):
the fused program, or with ``turbo_mode="stream"`` bounded-memory slabs;
``"tiles"``, and a stream at a rate with no integral 22 050 Hz hop, run the
fused program with a log line, as the JAX engine does.

raw_data keeps the JAX engine's schema: {rake_mask, f0, voiced_flag,
voiced_probs, rms, y, onset_env, mel_db, pitch_backend}, f0 zero-filled on
unvoiced frames.  The helpers of the JAX facade are here too:
``load_audio``, ``detect_rake_patterns``, ``separate_stems``,
``generate_tabs``, ``export_musicxml``.

There is no fallback: a device failure raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core.analyze import run_analyze
from aegis_tpu_torch.core.events import extract_events_v1
from aegis_tpu_torch.engine.turbo import (run_analyze_streamed,
                                          run_analyze_turbo)
from aegis_tpu_torch.io.audio import load_audio as _load_audio
from aegis_tpu_torch.midi.encode import events_to_midi
from aegis_tpu_torch.utils.logging import get_logger

log = get_logger("Aegis")


def normalize_turbo_mode(mode, n_samples: int, sample_rate: int,
                         stream_threshold_s: float = 240.0,
                         allow_stream: bool = True):
    """One canonical turbo vocabulary for the facades and the CLI.

    Returns False (fused single program), "tiles" (the tiled program) or
    "stream" (bounded-memory slabs):
      False | None | "" | "off"  -> False
      True | "tiles" | "turbo"   -> "tiles"
      "stream"                   -> "stream" (or "tiles" if not available)
      "auto"                     -> "stream" past stream_threshold_s,
                                    else False
    Unknown strings raise ValueError."""
    if mode in (False, None, "", "off"):
        return False
    if mode in (True, "tiles", "turbo"):
        return "tiles"
    if mode == "stream":
        return "stream" if allow_stream else "tiles"
    if mode == "auto":
        if n_samples / sample_rate > stream_threshold_s:
            return "stream" if allow_stream else "tiles"
        return False
    raise ValueError(f"unknown turbo mode: {mode!r}")


def analyze_pyin(y: np.ndarray, audio: AudioConfig, pyin_cfg: PyinConfig,
                 rake_sensitivity: float, turbo, turbo_config, fetch_mel: bool,
                 device, financial: bool = False,
                 use_guitar_filters: bool = True) -> Dict[str, np.ndarray]:
    """The Perception Phase of both facades, by normalized turbo mode:
    False = the fused program, "tiles" = the tiled program, "stream" =
    bounded-memory slabs."""
    kw = dict(fetch_mel=fetch_mel, financial=financial,
              use_guitar_filters=use_guitar_filters, device=device)
    if turbo == "stream":
        return run_analyze_streamed(y, audio, pyin_cfg, rake_sensitivity,
                                    turbo=turbo_config, **kw)
    if turbo:
        return run_analyze_turbo(y, audio, pyin_cfg, rake_sensitivity,
                                 turbo=turbo_config, **kw)
    return run_analyze(y, audio, pyin_cfg, rake_sensitivity, **kw)


def analyze_neural(y: np.ndarray, audio: AudioConfig, rake_sensitivity: float,
                   turbo, fetch_mel: bool, device, financial: bool = False,
                   use_guitar_filters: bool = True) -> Dict[str, np.ndarray]:
    """The Perception Phase of both facades with PitchNet, by normalized
    turbo mode: "stream" runs bounded-memory slabs (v1 only, and only where
    hop * 22050 / sr is integral); every other mode runs the fused program,
    with a log line where the caller asked for something else."""
    from aegis_tpu_torch.models.pitchnet import (default_params,
                                                 run_analyze_neural,
                                                 run_analyze_neural_streamed)

    sr, hop = audio.sample_rate, audio.hop_length
    params = default_params(device)
    kw = dict(n_fft=audio.n_fft, n_mels=audio.n_mels, fetch_mel=fetch_mel,
              device=device)
    if financial:
        if turbo:
            log.warning(f"neural backend runs the fused single program; "
                        f"turbo={turbo!r} ignored")
        return run_analyze_neural(y, sr, hop, params, rake_sensitivity,
                                  financial=True,
                                  use_guitar_filters=use_guitar_filters, **kw)
    if turbo == "stream":
        if (hop * 22050) % sr == 0:
            return run_analyze_neural_streamed(y, sr, hop, params,
                                               rake_sensitivity, **kw)
        log.warning(f"neural streamed mode needs an integral 22.05 kHz hop "
                    f"(sr={sr}); running the fused program")
        turbo = False
    if turbo:
        log.warning(f"neural backend has no sharded-tiles mode; "
                    f"turbo={turbo!r} runs the fused single program "
                    f"(turbo_mode='stream' for bounded memory)")
    return run_analyze_neural(y, sr, hop, params, rake_sensitivity, **kw)


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
        if pitch_backend not in ("pyin", "neural"):
            raise ValueError(f"unknown pitch backend: {pitch_backend!r}")

        if isinstance(input_wav, np.ndarray):
            y = input_wav.astype(np.float32)
        else:
            duration = (end_time - start_time) if end_time else None
            y, _ = _load_audio(input_wav, sr=self.sr, offset=start_time,
                               duration=duration)
        if len(y) == 0:
            return None
        turbo_mode = normalize_turbo_mode(
            kwargs.get("turbo_mode", False), len(y), self.sr,
            kwargs.get("stream_threshold_s", 240.0))

        log.info(f"Perception Phase ({self.device}, turbo={turbo_mode}, "
                 f"{len(y)/self.sr:.1f}s)")
        with torch.profiler.record_function("aegis.perception"):
            if pitch_backend == "neural":
                out = analyze_neural(y, self.audio, rake_sensitivity,
                                     turbo_mode, kwargs.get("fetch_mel", True),
                                     self.device)
            else:
                out = analyze_pyin(y, self.audio, self.pyin_cfg,
                                   rake_sensitivity, turbo_mode,
                                   kwargs.get("turbo_config"),
                                   kwargs.get("fetch_mel", True), self.device)

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
                # PitchNet fires up to ~a window early (phase-blind
                # magnitude features); the forward snap moves such starts
                # to the attack rise.  pYIN never fires early.
                onset_fwd_snap_ms=kwargs.get(
                    "onset_fwd_snap_ms",
                    100.0 if str(raw_data.get("pitch_backend", "")) == "neural"
                    else 0.0),
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
        from aegis_tpu_torch.core.tempo import estimate_bpm

        return estimate_bpm(raw_data, self.sr, self.hop_length)

    # ------------------------------------------------------------ persistence

    @staticmethod
    def save_raw(raw_data: Dict, path: str) -> None:
        np.savez_compressed(path, **raw_data)

    @staticmethod
    def load_raw(path: str) -> Dict:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    # --------------------------------------------------------------- helpers

    def load_audio(self, file_path: Union[str, bytes], start_time: float = 0,
                   end_time: Optional[float] = None):
        """Returns (y, S_dB) with S_dB in librosa layout (n_mels, T), from
        the NumPy reference spectrogram (host)."""
        from aegis_tpu_torch.ref.dsp_ref import melspectrogram, power_to_db

        duration = (end_time - start_time) if end_time else None
        y, _ = _load_audio(file_path, sr=self.sr, offset=start_time,
                           duration=duration)
        S_dB = power_to_db(melspectrogram(y, self.sr, self.audio.n_fft,
                                          self.hop_length, self.audio.n_mels))
        return y, S_dB

    def detect_rake_patterns(self, S_dB: np.ndarray,
                             rake_sensitivity: float = 0.6) -> np.ndarray:
        """S_dB in (n_mels, T) librosa layout (host helper)."""
        from aegis_tpu_torch.ref.masks_ref import detect_rake

        return detect_rake(S_dB.T, self.hop_length, self.sr, rake_sensitivity)

    def separate_stems(self, input_wav: str, output_dir: str) -> str:
        """The guitar-ish stem of a file (synth/stems.py, method "auto"),
        HPSS on the engine's device where Demucs is missing."""
        from aegis_tpu_torch.synth.stems import separate_stems

        return separate_stems(input_wav, output_dir, device=self.device)

    def generate_tabs(self, events: List[dict]) -> List[dict]:
        from aegis_tpu_torch.midi.tabs import generate_tabs

        return generate_tabs(events)

    def export_musicxml(self, tab_data: List[dict], xml_path: str) -> str:
        from aegis_tpu_torch.midi.musicxml import export_musicxml

        return export_musicxml(tab_data, xml_path)
