"""Technique verification by audio matching (PyTorch).

Counterpart of ``aegis_tpu/verify/technique.py``.  For each articulated
event (bend / vibrato / hammer_on / pull_off), render a mini-MIDI twice —
with and without the technique — and keep the technique only when the
with-version is more mel-similar to the original audio slice and the
similarity clears 0.6 (reference technique_verifier.py:58-99, mini-MIDI
builder :111-179, mel cosine :204-234).  The mel cosine runs on the device;
the probes, the envelope correlation and the mini-MIDI are host code copied
from the JAX package.

Unlike the JAX package, a failure while checking an event raises instead of
leaving the event unverified, so no device error is hidden.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.io.audio import to_mono
from aegis_tpu_torch.io.wav import read_wav
from aegis_tpu_torch.midi.encode import events_to_midi
from aegis_tpu_torch.synth.fluidsynth import get_synthesizer, synthesize_midi
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.verify.similarity import (cosine, stft_power_batch,
                                               similarity_tables)

log = get_logger("TechniqueVerifier")

_VERIFIABLE = {"bend", "vibrato", "hammer_on", "pull_off"}


def _mel_cosine(y_a: torch.Tensor, y_b: torch.Tensor, sr: int) -> float:
    """Cosine of the flattened 128-band mel spectrograms of two equal-length
    signals on their device."""
    tables = similarity_tables(sr, y_a.device)
    p = stft_power_batch(torch.stack([y_a, y_b]), 512, tables)
    mel = (p @ tables.mel_fb_t).reshape(2, -1)
    return float(cosine(mel[0], mel[1]))


def _mini_midi(event: Dict, sr: int, hop_length: int, with_technique: bool) -> bytes:
    evt = dict(event)
    evt["start"], evt["end"] = 0, max(1, event["end"] - event["start"])
    if not with_technique:
        evt["technique"] = None
    return events_to_midi([evt], sr, hop_length, output=None)


def _synth_audio(midi_bytes: bytes, sr: int, device) -> np.ndarray:
    wav = synthesize_midi(midi_bytes, sample_rate=sr, device=device)
    if wav is None:
        return np.zeros(sr // 2, np.float32)
    audio, native_sr = read_wav(wav)
    audio = to_mono(audio)
    if native_sr != sr:
        from aegis_tpu_torch.io.audio import resample

        audio = resample(audio, native_sr, sr)
    return audio


def _render_probe(note: int, dur_s: float, technique, velocity: int,
                  sr: int) -> np.ndarray:
    """Direct frequency-modulated probe for the with/without comparison.

    The ADSR MIDI fallback ignores pitch-wheel curves, which would make the
    with/without renders of bend and vibrato identical.  This renders the
    pitch modulation itself: bend = accelerating rise to +2 semitones (the
    reference's 15-point curve, aegis_engine.py:124-143), vibrato = 5 Hz
    +-0.3 semitone LFO; hammer_on/pull_off = the reference's velocity
    scaling (x0.6 / x0.5).
    """
    n = max(int(dur_s * sr), sr // 50)
    t = np.arange(n, dtype=np.float64) / sr
    f0 = 440.0 * 2.0 ** ((note - 69) / 12.0)
    semis = np.zeros(n)
    amp = velocity / 127.0
    attack_s = 0.01
    if technique == "bend":
        semis = 2.0 * (t / max(dur_s, 1e-3)) ** 2  # accelerating rise
    elif technique == "vibrato":
        semis = 0.3 * np.sin(2.0 * np.pi * 5.0 * t)
    elif technique in ("hammer_on", "pull_off"):
        # legato: no pick transient — soft slow attack.  A pure velocity
        # scale would be invisible to the scale-invariant mel cosine, so
        # the discriminating feature here is the attack SHAPE
        amp *= 0.6 if technique == "hammer_on" else 0.5
        attack_s = 0.05
    freq = f0 * 2.0 ** (semis / 12.0)
    phase = 2.0 * np.pi * np.cumsum(freq) / sr
    saw = 2.0 * ((phase / (2 * np.pi)) % 1.0) - 1.0
    env = np.minimum(1.0, t / attack_s)
    env *= np.minimum(1.0, (dur_s - t).clip(0) / 0.03 + 1e-9)
    return (0.6 * amp * saw * env).astype(np.float32)


def _envelope_pearson(a: np.ndarray, b: np.ndarray, sr: int) -> float:
    """RMS-envelope shape correlation in [0, 1] — amplitude-scale invariant
    but attack-SHAPE sensitive (unlike the mel cosine)."""
    frame = max(sr // 100, 64)
    m = min(len(a), len(b)) // frame
    if m < 3:
        return 0.0
    ra = np.sqrt((a[: m * frame].reshape(m, frame) ** 2).mean(axis=1))
    rb = np.sqrt((b[: m * frame].reshape(m, frame) ** 2).mean(axis=1))
    sa, sb = ra.std(), rb.std()
    if sa < 1e-10 or sb < 1e-10:
        return 1.0 if sa < 1e-10 and sb < 1e-10 else 0.0
    c = float(np.corrcoef(ra, rb)[0, 1])
    return max(0.0, (c + 1.0) / 2.0)


def verify_technique_by_audio_matching(
    y: np.ndarray,
    events: List[Dict],
    sr: int,
    hop_length: int,
    min_similarity: float = 0.6,
    device="cuda",
) -> List[Dict]:
    """Returns events with unsupported techniques stripped; each checked
    event gains {technique_verified, technique_similarity}."""
    dev = resolve_device(device)
    out = []
    checked = kept = 0
    for event in events:
        technique = event.get("technique")
        if technique not in _VERIFIABLE:
            out.append(event)
            continue
        checked += 1
        evt = dict(event)
        pad = int(sr * 0.05)
        start = max(0, event["start"] * hop_length - pad)
        end = min(len(y), event["end"] * hop_length + pad)
        orig = y[start:end]
        if len(orig) < sr * 0.05:
            out.append(evt)
            continue

        use_probe = not get_synthesizer().is_available()
        if not use_probe:
            with_audio = _synth_audio(
                _mini_midi(event, sr, hop_length, True), sr, dev)
            without_audio = _synth_audio(
                _mini_midi(event, sr, hop_length, False), sr, dev)
        else:
            # ADSR MIDI fallback ignores pitch wheels — render the
            # modulation directly (see _render_probe)
            dur_s = max(1, event["end"] - event["start"]) * hop_length / sr
            with_audio = _render_probe(event["note"], dur_s, technique,
                                       event.get("velocity", 100), sr)
            without_audio = _render_probe(event["note"], dur_s, None,
                                          event.get("velocity", 100), sr)

        n = 1 << 12
        while n < max(len(orig), len(with_audio), len(without_audio)):
            n <<= 1

        def pad_to(x):
            b = np.zeros(n, np.float32)
            b[: len(x)] = x[:n]
            return torch.from_numpy(b).to(dev)

        o = pad_to(orig)
        mel_with = _mel_cosine(o, pad_to(with_audio), sr)
        mel_without = _mel_cosine(o, pad_to(without_audio), sr)
        if technique in ("hammer_on", "pull_off") and use_probe:
            # amplitude/attack techniques: mel cosine is scale-invariant
            # and cannot see them — compare envelope shapes as well
            sim_with = 0.5 * _envelope_pearson(orig, with_audio, sr) + \
                0.5 * mel_with
            sim_without = 0.5 * _envelope_pearson(orig, without_audio,
                                                  sr) + 0.5 * mel_without
        else:
            sim_with, sim_without = mel_with, mel_without

        verified = sim_with > sim_without and sim_with > min_similarity
        evt["technique_similarity"] = round(sim_with, 4)
        evt["technique_verified"] = verified
        if not verified:
            evt["technique"] = None
        else:
            kept += 1
        out.append(evt)
    log.info(f"verified {kept}/{checked} technique events")
    return out
