"""MIDI encode and decode, re-exported from ``aegis_tpu/midi`` (pure
Python), so the port's scripts name only this package."""

from aegis_tpu.midi.decode import midi_to_notes  # noqa: F401
from aegis_tpu.midi.encode import events_to_midi, events_to_midi_financial  # noqa: F401
