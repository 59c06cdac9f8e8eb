from aegis_tpu_torch.midi.smf import (  # noqa: F401
    MidiMessage,
    MidiFile,
    MidiTrack,
    DEFAULT_TICKS_PER_BEAT,
    DEFAULT_TEMPO_US,
    second2tick,
    tick2second,
)
from aegis_tpu_torch.midi.decode import midi_to_notes  # noqa: F401
from aegis_tpu_torch.midi.encode import events_to_midi, events_to_midi_financial  # noqa: F401
