"""Guitar ADSR presets and effect presets (parameter data); a copy of
``aegis_tpu/synth/presets.py``.

Preset values match the reference's tables (synthesizer.py:179-200,
effect_learning_loop.py:34-49) so auto-matching / optimization behaves the
same way.
"""

GUITAR_ADSR_PRESETS = {
    "nylon": {"attack_ms": 5, "decay_ms": 80, "sustain_level": 0.6,
              "release_ms": 200, "waveform": "triangle"},
    "steel": {"attack_ms": 3, "decay_ms": 60, "sustain_level": 0.5,
              "release_ms": 150, "waveform": "sawtooth"},
    "electric_clean": {"attack_ms": 5, "decay_ms": 40, "sustain_level": 0.7,
                       "release_ms": 100, "waveform": "sawtooth"},
    "electric_overdrive": {"attack_ms": 2, "decay_ms": 30, "sustain_level": 0.8,
                           "release_ms": 300, "waveform": "square"},
    "muted": {"attack_ms": 2, "decay_ms": 20, "sustain_level": 0.2,
              "release_ms": 30, "waveform": "sawtooth"},
}

EFFECT_PRESETS = {
    "clean": [],
    "light_overdrive": [("distortion", {"drive": 0.3})],
    "heavy_distortion": [("distortion", {"drive": 0.8})],
    "ambient": [("reverb", {"room_size": 0.7}),
                ("delay", {"delay_ms": 400, "feedback": 0.3})],
    "chorus_clean": [("chorus", {"depth": 0.003, "rate": 1.5})],
    "full_fx": [("distortion", {"drive": 0.4}),
                ("chorus", {"depth": 0.002}),
                ("reverb", {"room_size": 0.5}),
                ("delay", {"delay_ms": 300, "feedback": 0.2})],
}

WAVEFORM_CODES = {"sine": 0, "sawtooth": 1, "square": 2, "triangle": 3}
WAVEFORM_NAMES = {v: k for k, v in WAVEFORM_CODES.items()}
