"""Standard MIDI File (SMF format 1) codec — pure Python, no dependencies.

The reference uses mido for all MIDI I/O (aegis_engine.py:98-179,
aegis_engine_financial.py:188-245).  mido is not in this framework's
dependency set, so this module provides a minimal, complete SMF reader/writer
with the same message vocabulary the pipeline needs:

  channel messages: note_on, note_off, program_change, pitchwheel,
                    control_change
  meta messages:    track_name, set_tempo, end_of_track

API is intentionally mido-flavored (MidiFile / MidiTrack / MidiMessage with
delta ``time``) so the rest of the framework reads naturally.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List, Optional, Union

DEFAULT_TICKS_PER_BEAT = 480
DEFAULT_TEMPO_US = 500000  # 120 BPM


def second2tick(seconds: float, ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT,
                tempo: int = DEFAULT_TEMPO_US) -> float:
    return seconds * 1e6 / tempo * ticks_per_beat


def tick2second(ticks: float, ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT,
                tempo: int = DEFAULT_TEMPO_US) -> float:
    return ticks * tempo / 1e6 / ticks_per_beat


def _encode_varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def _decode_varlen(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


@dataclasses.dataclass
class MidiMessage:
    """One MIDI event with a delta ``time`` in ticks.

    ``type`` is one of: note_on, note_off, program_change, pitchwheel,
    control_change, track_name, set_tempo, end_of_track, unknown_meta,
    sysex.
    """

    type: str
    time: int = 0
    note: int = 0
    velocity: int = 0
    program: int = 0
    pitch: int = 0  # pitchwheel: -8192..8191
    control: int = 0
    value: int = 0
    channel: int = 0
    name: str = ""  # track_name
    tempo: int = DEFAULT_TEMPO_US  # set_tempo
    data: bytes = b""  # unknown meta / sysex payload

    @property
    def is_meta(self) -> bool:
        return self.type in (
            "track_name",
            "set_tempo",
            "end_of_track",
            "unknown_meta",
        )


class MidiTrack(list):
    """A list of MidiMessage with delta times."""

    def append_msg(self, **kw) -> "MidiTrack":
        self.append(MidiMessage(**kw))
        return self


class MidiFile:
    def __init__(self, ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT):
        self.ticks_per_beat = ticks_per_beat
        self.tracks: List[MidiTrack] = []

    # ------------------------------------------------------------------ write

    def _encode_message(self, msg: MidiMessage) -> bytes:
        t = msg.type
        ch = msg.channel & 0x0F
        if t == "note_on":
            return bytes([0x90 | ch, msg.note & 0x7F, msg.velocity & 0x7F])
        if t == "note_off":
            return bytes([0x80 | ch, msg.note & 0x7F, msg.velocity & 0x7F])
        if t == "program_change":
            return bytes([0xC0 | ch, msg.program & 0x7F])
        if t == "control_change":
            return bytes([0xB0 | ch, msg.control & 0x7F, msg.value & 0x7F])
        if t == "pitchwheel":
            v = int(msg.pitch) + 8192
            v = max(0, min(16383, v))
            return bytes([0xE0 | ch, v & 0x7F, (v >> 7) & 0x7F])
        if t == "track_name":
            payload = msg.name.encode("utf-8")
            return bytes([0xFF, 0x03]) + _encode_varlen(len(payload)) + payload
        if t == "set_tempo":
            return bytes([0xFF, 0x51, 0x03]) + struct.pack(">I", msg.tempo)[1:]
        if t == "end_of_track":
            return bytes([0xFF, 0x2F, 0x00])
        raise ValueError(f"cannot encode message type {t!r}")

    def save(self, file: Union[str, io.BytesIO, None] = None) -> Optional[bytes]:
        """Serialize.  With a path/stream, writes there; with None, returns
        bytes."""
        out = io.BytesIO()
        out.write(b"MThd")
        out.write(struct.pack(">IHHH", 6, 1, len(self.tracks), self.ticks_per_beat))
        for track in self.tracks:
            body = io.BytesIO()
            has_eot = False
            for msg in track:
                body.write(_encode_varlen(int(msg.time)))
                body.write(self._encode_message(msg))
                if msg.type == "end_of_track":
                    has_eot = True
            if not has_eot:
                body.write(_encode_varlen(0))
                body.write(bytes([0xFF, 0x2F, 0x00]))
            payload = body.getvalue()
            out.write(b"MTrk")
            out.write(struct.pack(">I", len(payload)))
            out.write(payload)
        blob = out.getvalue()

        if file is None:
            return blob
        if hasattr(file, "write"):
            file.write(blob)
            return None
        with open(file, "wb") as f:
            f.write(blob)
        return None

    # ------------------------------------------------------------------- read

    @classmethod
    def load(cls, path_or_bytes: Union[str, bytes, io.BytesIO]) -> "MidiFile":
        if isinstance(path_or_bytes, bytes):
            data = path_or_bytes
        elif hasattr(path_or_bytes, "read"):
            data = path_or_bytes.read()
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()

        if data[:4] != b"MThd":
            raise ValueError("not an SMF file")
        # truncated/garbage input surfaces as ValueError, not struct.error /
        # IndexError — the server maps ValueError to a 400
        try:
            (hlen, _fmt, n_tracks, division) = struct.unpack_from(
                ">IHHH", data, 4)
            mid = cls(ticks_per_beat=division)
            pos = 8 + hlen
            for _ in range(n_tracks):
                if data[pos : pos + 4] != b"MTrk":
                    raise ValueError("bad track chunk")
                (tlen,) = struct.unpack_from(">I", data, pos + 4)
                body = data[pos + 8 : pos + 8 + tlen]
                mid.tracks.append(cls._parse_track(body))
                pos += 8 + tlen
        except (struct.error, IndexError) as e:
            raise ValueError(f"corrupt SMF: {e}") from e
        return mid

    @staticmethod
    def _parse_track(body: bytes) -> MidiTrack:
        track = MidiTrack()
        pos = 0
        running_status = 0
        while pos < len(body):
            delta, pos = _decode_varlen(body, pos)
            status = body[pos]
            if status & 0x80:
                pos += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status

            if status == 0xFF:  # meta
                meta_type = body[pos]
                pos += 1
                length, pos = _decode_varlen(body, pos)
                payload = body[pos : pos + length]
                pos += length
                if meta_type == 0x03:
                    track.append(
                        MidiMessage("track_name", time=delta,
                                    name=payload.decode("utf-8", "replace"))
                    )
                elif meta_type == 0x51:
                    tempo = struct.unpack(">I", b"\x00" + payload)[0]
                    track.append(MidiMessage("set_tempo", time=delta, tempo=tempo))
                elif meta_type == 0x2F:
                    track.append(MidiMessage("end_of_track", time=delta))
                else:
                    track.append(
                        MidiMessage("unknown_meta", time=delta, data=payload,
                                    value=meta_type)
                    )
            elif status in (0xF0, 0xF7):  # sysex
                length, pos = _decode_varlen(body, pos)
                payload = body[pos : pos + length]
                pos += length
                track.append(MidiMessage("sysex", time=delta, data=payload))
            else:
                kind = status & 0xF0
                ch = status & 0x0F
                if kind == 0x90:
                    note, vel = body[pos], body[pos + 1]
                    pos += 2
                    # note_on velocity 0 is a note_off by convention
                    mtype = "note_on" if vel > 0 else "note_off"
                    track.append(
                        MidiMessage(mtype, time=delta, note=note, velocity=vel,
                                    channel=ch)
                    )
                elif kind == 0x80:
                    note, vel = body[pos], body[pos + 1]
                    pos += 2
                    track.append(
                        MidiMessage("note_off", time=delta, note=note,
                                    velocity=vel, channel=ch)
                    )
                elif kind == 0xC0:
                    track.append(
                        MidiMessage("program_change", time=delta,
                                    program=body[pos], channel=ch)
                    )
                    pos += 1
                elif kind == 0xD0:  # channel pressure (skip payload)
                    pos += 1
                elif kind == 0xE0:
                    lsb, msb = body[pos], body[pos + 1]
                    pos += 2
                    track.append(
                        MidiMessage("pitchwheel", time=delta,
                                    pitch=((msb << 7) | lsb) - 8192, channel=ch)
                    )
                elif kind in (0xA0, 0xB0):
                    a, b = body[pos], body[pos + 1]
                    pos += 2
                    if kind == 0xB0:
                        track.append(
                            MidiMessage("control_change", time=delta, control=a,
                                        value=b, channel=ch)
                        )
                else:
                    raise ValueError(f"unhandled status byte 0x{status:02x}")
        return track
