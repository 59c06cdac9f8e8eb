"""AegisFinancialEngine — the v2 one-shot 5-phase pipeline facade (PyTorch).

Counterpart of ``aegis_tpu/engine/financial.py`` with the pYIN backend:
  [1/5] load audio (sr=22050) + mel spectrogram
  [2/5] rake detection
  [3/5] pYIN pitch tracking
  [3.5/5] guitar-specific filters (sub-E2, rake enhance, palm mute, distortion)
  [4/5] financial analysis (trend consensus, Bollinger articulations, MACD
        slides, RSI ghost filter, adaptive threshold) + harmonic filtering
  [5/5] dual named-track MIDI export

Phases 1-4a run on the engine's device as the fused program, the tiled
program or bounded-memory slabs (``turbo_mode``, as on the v1 engine).
``pitch_backend="neural"`` runs PitchNet's fused financial program
(``models.pitchnet``) whatever the turbo mode, as the JAX engine does.
There is no fallback: a device failure raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.engine.engine import normalize_turbo_mode
from aegis_tpu_torch.io.audio import load_audio as _load_audio
from aegis_tpu_torch.midi.encode import events_to_midi_financial
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.utils.prof import phase
from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.core.events import extract_events_financial
from aegis_tpu_torch.engine.engine import analyze_neural, analyze_pyin

log = get_logger("Financial")


class AegisFinancialEngine:
    version = "2.0-financial-torch"

    def __init__(self, sample_rate: int = 22050, hop_length: int = 512,
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

    def analyze(self, input_wav: Union[str, bytes, np.ndarray],
                **kwargs) -> Optional[Dict[str, np.ndarray]]:
        """Phases 1-4a (cacheable raw analysis).  Returns the frame-level
        analysis dict (f0 is NaN on unvoiced frames)."""
        pitch_backend = kwargs.get("pitch_backend", "pyin")
        if pitch_backend not in ("pyin", "neural"):
            raise ValueError(f"unknown pitch backend: {pitch_backend!r}")
        if isinstance(input_wav, np.ndarray):
            y = input_wav.astype(np.float32)
        else:
            start = kwargs.get("start_time", 0.0)
            end = kwargs.get("end_time", None)
            y, _ = _load_audio(input_wav, sr=self.sr, offset=start,
                               duration=(end - start) if end else None)
        if len(y) == 0:
            return None
        turbo_mode = normalize_turbo_mode(
            kwargs.get("turbo_mode", False), len(y), self.sr,
            kwargs.get("stream_threshold_s", 240.0))
        with phase("financial.perception", quiet=True):
            if pitch_backend == "neural":
                out = analyze_neural(
                    y, self.audio, kwargs.get("rake_sensitivity", 0.6),
                    turbo_mode, kwargs.get("fetch_mel", True), self.device,
                    financial=True,
                    use_guitar_filters=kwargs.get("use_guitar_filters", True))
            else:
                out = analyze_pyin(
                    y, self.audio, self.pyin_cfg,
                    kwargs.get("rake_sensitivity", 0.6), turbo_mode,
                    kwargs.get("turbo_config"), kwargs.get("fetch_mel", True),
                    self.device, financial=True,
                    use_guitar_filters=kwargs.get("use_guitar_filters", True))
        out["y"] = y
        out["pitch_backend"] = pitch_backend
        return out

    def extract_events(self, analysis: Dict[str, np.ndarray],
                       **kwargs) -> Tuple[List[dict], Dict]:
        """Phase 4b: events from cached analysis (re-runnable per slider).

        kwargs["bpm"]: a number, or "auto" to estimate from the onset
        envelope; the resolved value rides in info["bpm"] and keys the MIDI
        encoder's tempo (default: the reference's fixed 120 BPM)."""
        bpm = kwargs.get("bpm")
        if bpm == "auto":
            bpm = self.estimate_bpm(analysis)
        events, info = extract_events_financial(
            rake_mask=analysis["rake_mask"],
            f0=analysis["f0"],
            voiced_flag=analysis["voiced_flag"],
            active_probs=analysis["voiced_probs"],
            rms=analysis["rms"],
            sr=self.sr,
            hop_length=self.hop_length,
            trend=analysis["trend"],
            artic_codes=analysis["artic_codes"],
            slide_codes=analysis["slide_codes"],
            financial_confidence=analysis["financial_confidence"],
            confidence_threshold=kwargs.get("confidence_threshold", None),
            noise_gate_db=kwargs.get("noise_gate_db", -40),
            sustain_ms=kwargs.get("sustain_ms", 50),
            min_note_duration_ms=kwargs.get("min_note_duration_ms", 50),
            use_harmonic_filter=kwargs.get("use_harmonic_filter", True),
            harmonic_tolerance=kwargs.get("harmonic_tolerance", 1),
            # onset refinement: the library default, as on the v1 engine;
            # use_onsets=False restores the reference's merge/lag semantics
            onset_env=analysis.get("onset_env")
            if kwargs.get("use_onsets", True) else None,
            # the neural backend's forward onset snap (see the v1 facade)
            onset_fwd_snap_ms=kwargs.get(
                "onset_fwd_snap_ms",
                100.0 if str(analysis.get("pitch_backend", "")) == "neural"
                else 0.0),
            # "pyin" quantizes notes from the median-smoothed f0; "trend" is
            # the reference's over-smoothed semantics
            pitch_source=kwargs.get("pitch_source", "pyin"),
        )
        if bpm:
            info["bpm"] = float(bpm)
        return events, info

    def estimate_bpm(self, analysis: Dict[str, np.ndarray]):
        from aegis_tpu_torch.core.tempo import estimate_bpm

        return estimate_bpm(analysis, self.sr, self.hop_length)

    def audio_to_midi_financial(self, input_wav, output_mid,
                                **kwargs) -> Optional[str]:
        """One-shot pipeline; returns the output path (None if no notes)."""
        log.info(f"Aegis Financial Engine v{self.version} ({self.device})")
        analysis = self.analyze(input_wav, **kwargs)
        if analysis is None:
            return None
        log.info(f"[2/5] rake frames: {int(np.sum(analysis['rake_mask']))}")
        log.info(f"[3.5/5] mute frames: {int(np.sum(analysis['mute_mask']))}")

        events, info = self.extract_events(analysis, **kwargs)
        if not events:
            log.warning("no notes detected")
            return None

        main = sum(1 for e in events if e["track"] == "main")
        log.info(
            f"[4/5] events: {len(events)} (main {main} "
            f"{100.0 * main / len(events):.1f}%, safe {len(events) - main}) "
            f"threshold={info['threshold']:.3f}"
        )
        if info.get("key_info"):
            k = info["key_info"]
            log.info(f"[4/5] key: {k['key']} {k['mode']} ({k['confidence']:.2f})")

        events_to_midi_financial(events, self.sr, self.hop_length,
                                 bpm=info.get("bpm"), output=output_mid)
        log.info(f"[5/5] wrote {output_mid}")
        return output_mid
