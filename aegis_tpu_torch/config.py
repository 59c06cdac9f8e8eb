"""Typed configuration for the whole pipeline.

The reference has no config system — constants are hardcoded and UI sliders act
as the live config surface (reference: aegis_engine.py:17-20,
aegis_engine_financial.py:36-39, aegis_app.py:63-103).  Here everything is one
set of frozen dataclasses so that jitted functions can treat them as static
arguments and caches key correctly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def hz_to_midi(hz: float) -> float:
    return 12.0 * math.log2(hz / 440.0) + 69.0


def midi_to_hz(midi: float) -> float:
    return 440.0 * 2.0 ** ((midi - 69.0) / 12.0)


# Standard guitar range used throughout the reference (worker.py:10-11):
# pYIN fmin = E2, fmax = C6.
NOTE_E2_HZ = midi_to_hz(40)  # 82.4069 Hz
NOTE_C6_HZ = midi_to_hz(84)  # 1046.502 Hz


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio front-end parameters (reference: aegis_engine.py:17-20 uses
    sr=44100; aegis_engine_financial.py:36 uses sr=22050)."""

    sample_rate: int = 22050
    hop_length: int = 512
    n_fft: int = 2048
    n_mels: int = 128

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length

    @property
    def ms_per_frame(self) -> float:
        return 1000.0 * self.hop_length / self.sample_rate

    def n_frames(self, n_samples: int) -> int:
        """Number of centered STFT frames for an n_samples signal."""
        return 1 + n_samples // self.hop_length


@dataclasses.dataclass(frozen=True)
class PyinConfig:
    """pYIN probabilistic pitch tracking parameters.

    Defaults follow the published pYIN algorithm (Mauch & Dixon 2014) with the
    same fmin/fmax the reference passes to librosa.pyin (worker.py:9-15).
    """

    # one semitone BELOW the reference's E2 lower bound: with fmin exactly at
    # E2 (worker.py:10-11), a clean 82.4 Hz tone's fundamental CMNDF trough
    # sits at the clipped max-period edge and pYIN fails to lock (observed:
    # re-transcribing a synthesized low E gave voiced=0.11).  The financial
    # path still removes sub-E2 pitches (masks.filter_subharmonic at 82.4).
    fmin: float = NOTE_E2_HZ * 2.0 ** (-1.0 / 12.0)
    fmax: float = NOTE_C6_HZ
    frame_length: int = 2048
    win_length: int = 1024  # frame_length // 2
    n_thresholds: int = 100
    beta_a: float = 2.0
    beta_b: float = 18.0
    boltzmann_parameter: float = 2.0
    resolution: float = 0.1  # semitones per pitch bin
    max_transition_rate: float = 35.92  # octaves per second
    switch_prob: float = 0.01
    no_trough_prob: float = 0.01

    @property
    def n_bins_per_semitone(self) -> int:
        return int(round(1.0 / self.resolution))

    @property
    def n_pitch_bins(self) -> int:
        return (
            int(math.floor(12 * self.n_bins_per_semitone * math.log2(self.fmax / self.fmin)))
            + 1
        )

    def min_period(self, sr: int) -> int:
        return max(int(math.floor(sr / self.fmax)), 1)

    def max_period(self, sr: int) -> int:
        return min(
            int(math.ceil(sr / self.fmin)), self.frame_length - self.win_length - 1
        )

    def transition_width(self, sr: int, hop_length: int) -> int:
        """Half-width (in pitch bins) of the banded pitch transition."""
        return (
            int(
                round(
                    self.max_transition_rate
                    * 12
                    * self.n_bins_per_semitone
                    * hop_length
                    / sr
                )
            )
            + 1
        )


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Event-extraction parameters.  Defaults mirror the reference UI sliders
    (aegis_app.py:63-103, static/index.html:472-476)."""

    confidence_threshold: Optional[float] = 0.70  # None => adaptive (v2)
    noise_gate_db: float = -40.0
    min_note_duration_ms: float = 50.0
    sustain_ms: float = 50.0
    rake_sensitivity: float = 0.6
    midi_program: int = 27  # clean electric guitar
    vibrato_rate: float = 5.0
    vibrato_depth: float = 0.3


@dataclasses.dataclass(frozen=True)
class TurboConfig:
    """Sharded / tiled execution parameters (replaces the reference's
    multiprocessing Turbo mode, aegis_engine.py:183-216)."""

    tile_frames: int = 1024  # frames per time tile
    halo_frames: int = 64  # HMM context overlap on each side
    data_axis: str = "data"
    time_axis: str = "time"


DEFAULT_AUDIO = AudioConfig()
DEFAULT_PYIN = PyinConfig()
DEFAULT_DETECTOR = DetectorConfig()
DEFAULT_TURBO = TurboConfig()
