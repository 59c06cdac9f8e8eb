"""Effect learning loop: closed-loop robustness-under-effects optimization;
a copy of ``aegis_tpu/verify/effect_loop.py`` on the port's effects and
engine.

Known MIDI -> synth -> device effect chain -> re-transcribe -> compare ->
heuristic parameter adjustment, for up to ``max_iterations`` rounds or until
``target_accuracy`` (reference effect_learning_loop.py:489-725; parameter
adjuster :748-841).  Accuracy = 0.5*note + 0.3*pitch + 0.2*timing.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, List, Optional

import numpy as np

from aegis_tpu_torch.io.audio import to_mono
from aegis_tpu_torch.io.wav import read_wav
from aegis_tpu_torch.midi.decode import midi_to_notes
from aegis_tpu_torch.synth.effects import EFFECT_PRESETS, apply_effect_chain
from aegis_tpu_torch.synth.fluidsynth import synthesize_midi
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.verify.reverse import compare_note_lists

log = get_logger("EffectLearningLoop")


def adjust_parameters(params: Dict, accuracy: Dict, original_notes: List[dict],
                      reversed_notes: List[dict],
                      rng: Optional[np.random.Generator] = None) -> Dict:
    """Heuristic parameter step (count-ratio / timing / pitch rules with a
    random-jitter escape when nothing changes)."""
    new = dict(params)
    orig_count, rev_count = len(original_notes), len(reversed_notes)

    if orig_count > 0 and rev_count > 0:
        ratio = rev_count / orig_count
        if ratio < 0.7:
            new["confidence_threshold"] = max(0.1, params["confidence_threshold"] - 0.05)
        elif ratio > 1.5:
            new["confidence_threshold"] = min(0.8, params["confidence_threshold"] + 0.05)
    elif rev_count == 0:
        new["confidence_threshold"] = max(0.1, params["confidence_threshold"] - 0.1)

    if accuracy["timing_accuracy"] < 0.5:
        new["min_note_duration_ms"] = max(20, params["min_note_duration_ms"] - 10)
    elif accuracy["note_accuracy"] > 0.8 and accuracy["timing_accuracy"] < 0.7:
        new["min_note_duration_ms"] = max(20, params["min_note_duration_ms"] - 5)

    if accuracy["pitch_accuracy"] < 0.5:
        new["sustain_ms"] = max(50, params["sustain_ms"] - 30)
    elif accuracy["note_accuracy"] < 0.5:
        new["sustain_ms"] = min(500, params["sustain_ms"] + 30)

    if new == params:  # random exploration to escape local optima
        rng = rng or np.random.default_rng()
        new["confidence_threshold"] = float(
            np.clip(params["confidence_threshold"] + rng.uniform(-0.03, 0.03),
                    0.1, 0.8)
        )
        new["min_note_duration_ms"] = int(
            np.clip(params["min_note_duration_ms"] + rng.integers(-5, 6), 20, 200)
        )
        new["sustain_ms"] = int(
            np.clip(params["sustain_ms"] + rng.integers(-20, 21), 50, 500)
        )
    return new


def learning_loop(
    midi_data: bytes,
    engine,
    effects_config=None,
    preset: Optional[str] = None,
    max_iterations: int = 5,
    target_accuracy: float = 0.95,
    sample_rate: int = 44100,
    progress_callback: Optional[Callable] = None,
    seed: Optional[int] = 0,
) -> Optional[Dict]:
    """Run the loop on ``engine.device``.  Returns {best_params,
    best_accuracy, history, effect_profile}."""
    if effects_config is None:
        effects_config = EFFECT_PRESETS.get(preset or "clean", [])

    original_notes = midi_to_notes(midi_data)
    if not original_notes:
        log.warning("no notes in input MIDI")
        return None

    wav = synthesize_midi(midi_data, sample_rate=sample_rate,
                          device=engine.device)
    if wav is None:
        return None
    audio, sr = read_wav(wav)
    audio = to_mono(audio)

    log.info(f"applying effect chain ({len(effects_config)} effects)")
    effected = apply_effect_chain(audio, effects_config, sr=sr,
                                  device=engine.device)
    if sr != engine.sr:
        from aegis_tpu_torch.io.audio import resample

        effected = resample(effected, sr, engine.sr)

    params = {"confidence_threshold": 0.3, "min_note_duration_ms": 50,
              "sustain_ms": 200}
    best_params = dict(params)
    best_accuracy = {"note_accuracy": 0.0, "pitch_accuracy": 0.0,
                     "timing_accuracy": 0.0, "overall": 0.0}
    history = []
    rng = np.random.default_rng(seed)

    raw = engine.audio_to_midi(effected, None)  # analyze once, re-filter per iter

    for iteration in range(1, max_iterations + 1):
        log.info(
            f"iter {iteration}/{max_iterations}: conf="
            f"{params['confidence_threshold']:.3f} dur="
            f"{params['min_note_duration_ms']} sus={params['sustain_ms']}"
        )
        accuracy = {"note_accuracy": 0.0, "pitch_accuracy": 0.0,
                    "timing_accuracy": 0.0, "overall": 0.0}
        reversed_notes: List[dict] = []
        if raw is not None:
            buf = io.BytesIO()
            engine.extract_events(
                raw, buf,
                confidence_threshold=params["confidence_threshold"],
                min_note_duration_ms=params["min_note_duration_ms"],
                sustain_ms=params["sustain_ms"],
                midi_program=27,
            )
            reversed_notes = midi_to_notes(buf.getvalue())
            comparison = compare_note_lists(original_notes, reversed_notes)
            overall = (comparison["note_accuracy"] * 0.5
                       + comparison["pitch_accuracy"] * 0.3
                       + comparison["timing_accuracy"] * 0.2)
            accuracy = {**comparison, "overall": overall}

        history.append({"iteration": iteration, "params": dict(params),
                        "accuracy": dict(accuracy)})
        if accuracy["overall"] > best_accuracy["overall"]:
            best_accuracy = dict(accuracy)
            best_params = dict(params)
            log.info(f"new best: {accuracy['overall']:.1%}")
        if progress_callback:
            progress_callback(iteration, max_iterations, accuracy)
        if accuracy["overall"] >= target_accuracy:
            log.info(f"target reached ({accuracy['overall']:.1%})")
            break
        params = adjust_parameters(params, accuracy, original_notes,
                                   reversed_notes, rng)

    return {
        "best_params": best_params,
        "best_accuracy": best_accuracy,
        "history": history,
        "effect_profile": preset or "custom",
    }
