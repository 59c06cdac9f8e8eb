"""Piano-roll visualizers; a copy of ``aegis_tpu/viz/piano_roll.py`` whose
inline ADSR audio renders on the port's synth.

Four engines, mirroring the reference's visualizer family
(aegis_engine_core/visualizers.py):

  * ``svg`` — pure-Python MIDI/event -> SVG renderer, zero dependencies,
    works offline (:6-100).  This is the default and also powers the
    financial realtime app's main=green / safe=pink roll
    (financial_app_realtime.py:31-119).
  * ``html_midi_player`` — <midi-player> web-component embed (:102-119)
  * ``tonejs`` — @tonejs/midi + canvas renderer embed (:121-177)
  * ``webaudiofont`` — WebAudioFont player embed (:179-187)

The three embed engines return self-contained HTML strings (CDN-based; the
host app decides whether to use them).  ``render_piano_roll`` is the
dispatcher (:189-213).
"""

from __future__ import annotations

import base64
import html
from typing import List, Union

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.midi.decode import midi_to_notes

TRACK_COLORS = {"main": "#34c759", "safe": "#ff6b9d"}  # green / pink
DEFAULT_COLOR = "#4a9eff"


def _note_rects(notes: List[dict], width: int, height: int,
                color_by_track: bool = False):
    if not notes:
        return [], 0.0, (60, 72)
    t_max = max(n["end"] for n in notes) or 1.0
    lo = min(n["note"] for n in notes) - 2
    hi = max(n["note"] for n in notes) + 2
    span = max(hi - lo, 12)
    rects = []
    for n in notes:
        x = n["start"] / t_max * width
        w = max((n["end"] - n["start"]) / t_max * width, 2.0)
        y = height - (n["note"] - lo + 1) / span * height
        h = max(height / span - 1, 2.0)
        if color_by_track:
            color = TRACK_COLORS.get(n.get("track", ""), DEFAULT_COLOR)
        else:
            color = DEFAULT_COLOR
        vel = n.get("velocity", 100)
        rects.append((x, y, w, h, color, 0.35 + 0.65 * min(vel, 127) / 127.0, n))
    return rects, t_max, (lo, hi)


def notes_to_svg(notes: List[dict], width: int = 880, height: int = 320,
                 color_by_track: bool = False, title: str = "") -> str:
    """Self-contained SVG piano roll from a note list ({note, start, end,
    velocity[, track]}, seconds)."""
    rects, t_max, (lo, hi) = _note_rects(notes, width, height, color_by_track)
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height + 24}" viewBox="0 0 {width} {height + 24}">',
        f'<rect width="{width}" height="{height}" fill="#14161c"/>',
    ]
    # octave grid lines
    for note in range((lo // 12) * 12, hi + 12, 12):
        y = height - (note - lo + 1) / max(hi - lo, 12) * height
        if 0 <= y <= height:
            parts.append(
                f'<line x1="0" y1="{y:.1f}" x2="{width}" y2="{y:.1f}" '
                f'stroke="#2a2e3a" stroke-width="0.5"/>'
            )
    # second ticks
    for s in range(int(t_max) + 1):
        x = s / max(t_max, 1e-6) * width
        parts.append(
            f'<line x1="{x:.1f}" y1="0" x2="{x:.1f}" y2="{height}" '
            f'stroke="#232734" stroke-width="0.5"/>'
            f'<text x="{x + 2:.1f}" y="{height + 14}" fill="#8a8fa3" '
            f'font-size="10">{s}s</text>'
        )
    for x, y, w, h, color, opacity, _ in rects:
        parts.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" height="{h:.1f}" '
            f'rx="1.5" fill="{color}" fill-opacity="{opacity:.2f}"/>'
        )
    if title:
        parts.append(
            f'<text x="8" y="16" fill="#d0d4e0" font-size="12">'
            f"{html.escape(title)}</text>"
        )
    parts.append("</svg>")
    return "".join(parts)


def events_to_svg(events: List[dict], sr: int, hop_length: int,
                  **kwargs) -> str:
    """Frame-indexed engine events -> SVG (main/safe colored)."""
    spf = hop_length / sr
    notes = [
        {"note": e["note"], "start": e["start"] * spf, "end": e["end"] * spf,
         "velocity": e.get("velocity", 100), "track": e.get("track", "main")}
        for e in events
    ]
    kwargs.setdefault("color_by_track", True)
    return notes_to_svg(notes, **kwargs)


def midi_to_svg(midi_data: Union[bytes, str], **kwargs) -> str:
    return notes_to_svg(midi_to_notes(midi_data), **kwargs)


# ---------------------------------------------------------------- CDN embeds

def _midi_data_url(midi_data: bytes) -> str:
    return "data:audio/midi;base64," + base64.b64encode(midi_data).decode()


def html_midi_player_embed(midi_data: bytes, height: int = 360) -> str:
    url = _midi_data_url(midi_data)
    return f"""
<script src="https://cdn.jsdelivr.net/combine/npm/tone@14.7.58,npm/@magenta/music@1.23.1/es6/core.js,npm/focus-visible@5,npm/html-midi-player@1.5.0"></script>
<midi-player src="{url}" sound-font visualizer="#aegisViz" style="width:100%"></midi-player>
<midi-visualizer type="piano-roll" id="aegisViz" src="{url}" style="height:{height}px"></midi-visualizer>
"""


#: minimal inline SMF parser (original implementation) — enough for the
#: canvas renderer: header division, per-track delta decoding with running
#: status, note_on/note_off pairing, set_tempo metas for tick→seconds.
#: Replaces the reference's vendored @tonejs/midi bundle
#: (aegis_engine_core/tonejs_midi.js, component #33) with ~60 lines of
#: dependency-free JS, so this engine works fully offline.
_SMF_PARSER_JS = """
function aegisParseSmf(buf) {
  const d = new DataView(buf); let p = 0;
  const u32 = () => { const v = d.getUint32(p); p += 4; return v; };
  const u16 = () => { const v = d.getUint16(p); p += 2; return v; };
  const u8 = () => d.getUint8(p++);
  const varlen = () => { let v = 0, b;
    do { b = u8(); v = (v << 7) | (b & 0x7f); } while (b & 0x80);
    return v; };
  if (u32() !== 0x4d546864) return [];          // "MThd"
  const hlen = u32(); u16(); const ntrk = u16(); const div = u16();
  p += hlen - 6;
  // SMPTE division (high bit set): high byte = -fps (two's complement),
  // low byte = ticks/frame; seconds per tick is then constant and tempo
  // metas are ignored (29 fps means 29.97 drop-frame per the SMF spec)
  const smpte = (div & 0x8000) !== 0;
  let fps = smpte ? 256 - (div >> 8) : 0;
  if (fps === 29) fps = 29.97;
  const tpf = div & 0xff;
  const events = [];                             // {tick, kind, ch, a, b}
  for (let t = 0; t < ntrk; t++) {
    if (u32() !== 0x4d54726b) break;             // "MTrk"
    // read the length BEFORE adding p: `p + u32()` evaluates the old p
    // and parses every track 4 bytes short (masked by trailing
    // end-of-track metas until a hand-authored file hit it)
    const tlen = u32(); const end = p + tlen;
    let tick = 0, status = 0;
    while (p < end) {
      tick += varlen(); let b0 = u8();
      if (b0 < 0x80) { p--; b0 = status; } else status = b0;
      const type = b0 & 0xf0;
      // meta/sysex cancel running status (a data byte after them is a
      // malformed file, not a meta continuation)
      if (b0 === 0xff) { status = 0; const meta = u8(), len = varlen();
        if (meta === 0x51) { const us = (d.getUint8(p) << 16) |
            (d.getUint8(p + 1) << 8) | d.getUint8(p + 2);
          events.push({tick, kind: "tempo", us}); }
        p += len;
      } else if (b0 === 0xf0 || b0 === 0xf7) { status = 0; p += varlen();
      } else if (type === 0xc0 || type === 0xd0) { u8();
      } else { const a = u8(), b = u8();
        if (type === 0x90) events.push({tick, kind: b ? "on" : "off",
                                        note: a, vel: b});
        else if (type === 0x80) events.push({tick, kind: "off", note: a});
      }
    }
  }
  events.sort((x, y) => x.tick - y.tick);
  let us = 500000, lastTick = 0, sec = 0;
  const open = {}, notes = [];
  for (const e of events) {
    sec += smpte ? (e.tick - lastTick) / (fps * tpf)
                 : (e.tick - lastTick) / div * us / 1e6;
    lastTick = e.tick;
    if (e.kind === "tempo") us = e.us;
    else if (e.kind === "on") open[e.note] = {time: sec,
        midi: e.note, velocity: (e.vel || 100) / 127};
    else if (e.kind === "off" && open[e.note]) {
      const n = open[e.note]; n.duration = Math.max(sec - n.time, 1e-3);
      notes.push(n); delete open[e.note];
    }
  }
  return notes;
}
"""


def tonejs_canvas_embed(midi_data: bytes, height: int = 360) -> str:
    """Canvas piano roll — fully OFFLINE: the reference's engine pulled
    @tonejs/midi from a CDN (or its vendored bundle, component #33); this
    build inlines its own SMF parser instead, so the markup has zero
    network dependencies."""
    url = _midi_data_url(midi_data)
    return f"""
<canvas id="aegisRoll" width="880" height="{height}" style="width:100%;background:#14161c"></canvas>
<script>
{_SMF_PARSER_JS}
fetch("{url}").then(r => r.arrayBuffer()).then(buf => {{
  const notes = aegisParseSmf(buf);
  const cv = document.getElementById("aegisRoll"), ctx = cv.getContext("2d");
  if (!notes.length) return;
  const tMax = Math.max(...notes.map(n => n.time + n.duration));
  const lo = Math.min(...notes.map(n => n.midi)) - 2;
  const hi = Math.max(...notes.map(n => n.midi)) + 2;
  for (const n of notes) {{
    ctx.fillStyle = "#4a9eff";
    ctx.globalAlpha = 0.35 + 0.65 * n.velocity;
    ctx.fillRect(n.time / tMax * cv.width,
                 cv.height - (n.midi - lo + 1) / (hi - lo) * cv.height,
                 Math.max(n.duration / tMax * cv.width, 2),
                 Math.max(cv.height / (hi - lo) - 1, 2));
  }}
}});
</script>
"""


def webaudiofont_embed(midi_data: bytes) -> str:
    url = _midi_data_url(midi_data)
    return f"""
<script src="https://surikov.github.io/webaudiofont/npm/dist/WebAudioFontPlayer.js"></script>
<p>WebAudioFont player: <a download="aegis.mid" href="{url}">download MIDI</a></p>
"""


#: engines whose markup needs the network: html_midi_player pulls the
#: magenta player/soundfont stack (audio synthesis in the browser — not
#: reimplementable inline), webaudiofont its player script.  svg and
#: tonejs (inline SMF parser) are fully self-contained.
ONLINE_ONLY_ENGINES = frozenset({"html_midi_player", "webaudiofont"})


def _adsr_audio_embed(midi_data: bytes, sample_rate: int = 22050,
                      preset: str = "electric_clean", device="cuda") -> str:
    """<audio> element with the MIDI rendered to WAV through the batched
    ADSR synth (synth/adsr.py), base64-inlined — browser playback with
    zero network.  The reference kept offline playback by vendoring the
    @tonejs/midi + html-midi-player bundles
    (aegis_engine_core/tonejs_midi.js, visualizers.py:102-177); here the
    framework's own synthesizer IS the player, so the markup needs no JS
    at all.  ~44 KB of base64 per second of audio at 22.05 kHz."""
    from aegis_tpu_torch.synth.adsr import synthesize_midi_adsr

    wav = synthesize_midi_adsr(midi_data, preset=preset,
                               sample_rate=sample_rate, device=device)
    url = "data:audio/wav;base64," + base64.b64encode(wav).decode()
    return f'<audio controls src="{url}" style="width:100%"></audio>'


def render_piano_roll(midi_data: bytes, engine: str = "svg",
                      offline: bool = False, audio: bool | None = None,
                      device="cuda", **kwargs) -> str:
    """Dispatcher across the four engines; returns SVG or HTML markup.

    ``offline=True`` guarantees network-free markup that is still
    PLAYABLE on every engine: the CDN-backed players (ONLINE_ONLY_ENGINES)
    demote to the SVG roll, and all four engines gain an inline
    ADSR-rendered ``<audio>`` element (_adsr_audio_embed) — the
    framework's synthesizer replaces the reference's vendored JS player
    bundles (component #33).  ``audio=False`` opts out (e.g. for
    size-sensitive embeds); ``audio=True`` adds the element to online
    markup too.  The ADSR render runs on ``device``."""
    device = resolve_device(device)
    if audio is None:
        audio = offline
    if offline and engine in ONLINE_ONLY_ENGINES:
        engine = "svg"
        kwargs = {k: v for k, v in kwargs.items() if k == "height"}
    if engine == "svg":
        markup = midi_to_svg(midi_data, **kwargs)
    elif engine == "html_midi_player":
        markup = html_midi_player_embed(midi_data, **kwargs)
    elif engine == "tonejs":
        markup = tonejs_canvas_embed(midi_data, **kwargs)
    elif engine == "webaudiofont":
        markup = webaudiofont_embed(midi_data)
    else:
        raise ValueError(f"unknown visualizer engine: {engine}")
    if audio:
        markup = markup + "\n" + _adsr_audio_embed(midi_data, device=device)
    return markup
