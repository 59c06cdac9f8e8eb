"""MusicXML export with guitar technical notation.

Mirrors the reference exporter (aegis_engine_core/tabs.py:40-112): a 3.1
score-partwise document with <string>/<fret> technical elements, bend /
slur / wavy-line articulations, 6-line staff details for tablature import
into Guitar Pro / Sibelius / MuseScore.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List

_STEP_MAP = {0: "C", 1: "C", 2: "D", 3: "D", 4: "E", 5: "F", 6: "F",
             7: "G", 8: "G", 9: "A", 10: "A", 11: "B"}
_SHARP = {1, 3, 6, 8, 10}


def export_musicxml(tab_data: List[dict], output_path: str) -> str:
    score = ET.Element("score-partwise", version="3.1")
    part_list = ET.SubElement(score, "part-list")
    score_part = ET.SubElement(part_list, "score-part", id="P1")
    ET.SubElement(score_part, "part-name").text = "Aegis Guitar"

    part = ET.SubElement(score, "part", id="P1")
    measure = ET.SubElement(part, "measure", number="1")

    attr = ET.SubElement(measure, "attributes")
    ET.SubElement(attr, "divisions").text = "1"
    key = ET.SubElement(attr, "key")
    ET.SubElement(key, "fifths").text = "0"
    time = ET.SubElement(attr, "time")
    ET.SubElement(time, "beats").text = "4"
    ET.SubElement(time, "beat-type").text = "4"
    clef = ET.SubElement(attr, "clef")
    ET.SubElement(clef, "sign").text = "G"
    ET.SubElement(clef, "line").text = "2"
    staff_details = ET.SubElement(attr, "staff-details")
    ET.SubElement(staff_details, "staff-lines").text = "6"

    prev_time = None
    for t in tab_data:
        note = ET.SubElement(measure, "note")
        # simultaneous tab entries (same onset, distinct strings from the
        # chord-aware fingering) carry the MusicXML <chord/> marker so
        # notation software stacks them on one stem
        if prev_time is not None and t.get("time") == prev_time:
            ET.SubElement(note, "chord")
        prev_time = t.get("time")
        pitch = ET.SubElement(note, "pitch")
        pitch_val = int(t["note"])
        ET.SubElement(pitch, "step").text = _STEP_MAP[pitch_val % 12]
        if pitch_val % 12 in _SHARP:
            ET.SubElement(pitch, "alter").text = "1"
        ET.SubElement(pitch, "octave").text = str(pitch_val // 12 - 1)
        ET.SubElement(note, "duration").text = "1"
        ET.SubElement(note, "type").text = "quarter"

        notations = ET.SubElement(note, "notations")
        technical = ET.SubElement(notations, "technical")
        ET.SubElement(technical, "string").text = str(t["string"])
        ET.SubElement(technical, "fret").text = str(t["fret"])

        technique = t.get("technique")
        if technique == "bend":
            bend = ET.SubElement(technical, "bend")
            ET.SubElement(bend, "bend-alter").text = "2"
        elif technique == "slide":
            ET.SubElement(notations, "slur", type="start", number="1")
        elif technique == "vibrato":
            ornaments = ET.SubElement(notations, "ornaments")
            ET.SubElement(ornaments, "wavy-line", type="start", number="1")
        elif technique == "hammer_on":
            ET.SubElement(technical, "hammer-on", type="start")
        elif technique == "pull_off":
            ET.SubElement(technical, "pull-off", type="start")

    ET.ElementTree(score).write(output_path, encoding="UTF-8",
                                xml_declaration=True)
    return output_path
