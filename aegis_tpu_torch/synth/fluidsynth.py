"""FluidSynth CLI wrapper (SoundFont MIDI -> WAV) with ADSR fallback; a copy
of ``aegis_tpu/synth/fluidsynth.py`` whose ADSR step runs on ``device``.

Mirrors the reference's wrapper behavior (synthesizer.py:18-176): soundfont
discovery across standard paths, ``-ni -g 0.8 -r SR -F out.wav`` invocation,
30 s timeout — minus the hardcoded user-specific binary path (found on PATH
or $AEGIS_FLUIDSYNTH_BIN instead).  ``synthesize_midi`` is the framework-wide
entry with the graceful-degradation ladder FluidSynth -> ADSR soft synth
(the reference's servers fall back the same way, server.py:273-277).
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Union

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.utils.logging import get_logger

log = get_logger("Synth")

_SOUNDFONT_PATHS = (
    "/usr/share/sounds/sf2/FluidR3_GM.sf2",
    "/usr/share/soundfonts/default.sf2",
    "/usr/local/share/soundfonts/default.sf2",
)


class FluidSynthSynthesizer:
    def __init__(self, fluidsynth_path: Optional[str] = None):
        self.fluidsynth_path = (
            fluidsynth_path
            or os.environ.get("AEGIS_FLUIDSYNTH_BIN")
            or shutil.which("fluidsynth")
        )
        self.soundfont = self._find_soundfont()

    @staticmethod
    def _find_soundfont() -> Optional[str]:
        env = os.environ.get("AEGIS_SOUNDFONT")
        if env and os.path.exists(env):
            return env
        for p in _SOUNDFONT_PATHS:
            if os.path.exists(p):
                return p
        return None

    def is_available(self) -> bool:
        if not self.fluidsynth_path or not self.soundfont:
            return False
        try:
            r = subprocess.run([self.fluidsynth_path, "--version"],
                               capture_output=True, timeout=5)
            return r.returncode == 0
        except (FileNotFoundError, subprocess.TimeoutExpired):
            return False

    def midi_to_wav(self, midi_data: Union[bytes, io.BytesIO],
                    sample_rate: int = 44100) -> bytes:
        if isinstance(midi_data, io.BytesIO):
            midi_data = midi_data.getvalue()
        with tempfile.NamedTemporaryFile(suffix=".mid", delete=False) as mt:
            mt.write(midi_data)
            midi_path = mt.name
        wav_path = midi_path + ".wav"
        try:
            cmd = [
                self.fluidsynth_path, "-ni", "-g", "0.8",
                "-r", str(sample_rate), "-F", wav_path,
                self.soundfont, midi_path,
            ]
            r = subprocess.run(cmd, capture_output=True, timeout=30,
                               stdin=subprocess.DEVNULL)
            if r.returncode != 0:
                raise RuntimeError(f"fluidsynth failed: {r.stderr[:300]}")
            with open(wav_path, "rb") as f:
                return f.read()
        finally:
            for p in (midi_path, wav_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass


_singleton: Optional[FluidSynthSynthesizer] = None


def get_synthesizer() -> FluidSynthSynthesizer:
    global _singleton
    if _singleton is None:
        _singleton = FluidSynthSynthesizer()
    return _singleton


def synthesize_midi(midi_data: Union[bytes, io.BytesIO],
                    sample_rate: int = 44100, device="cuda") -> Optional[bytes]:
    """MIDI -> WAV: FluidSynth when present, else the batched ADSR synth on
    ``device``."""
    device = resolve_device(device)
    synth = get_synthesizer()
    if synth.is_available():
        try:
            return synth.midi_to_wav(midi_data, sample_rate)
        except Exception as e:
            log.warning(f"fluidsynth failed ({e}); ADSR fallback")
    from aegis_tpu_torch.synth.adsr import synthesize_midi_adsr

    return synthesize_midi_adsr(midi_data, sample_rate=sample_rate,
                                device=device)
