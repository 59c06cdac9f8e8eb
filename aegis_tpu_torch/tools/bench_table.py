"""Regenerate the README's table of the port's numbers from a committed
bench artifact measured on an NVIDIA card.

The JAX package's tool (``aegis_tpu/tools/bench_table.py``) renders the
README's ``BENCH_TABLE`` block from the newest ``BENCH_r{N}.json`` whose
device is the TPU.  Those are TPU numbers, and the port prints none of
them: this tool cites only an artifact that records an NVIDIA card, its
name and its power limit (see ``gpu_card``), skips every other artifact and
declares the skip in the caption, as the JAX tool does.  It owns only its
own markers, ``<!-- TORCH_BENCH_TABLE_START ... -->`` to
``<!-- TORCH_BENCH_TABLE_END -->`` in the README's port section, and never
touches the JAX block:

    python -m aegis_tpu_torch.tools.bench_table [artifact.json] [--write]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
START = "<!-- TORCH_BENCH_TABLE_START"
END = "<!-- TORCH_BENCH_TABLE_END -->"


def _record(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return (rec.get("parsed") or rec) if isinstance(rec, dict) else None


def gpu_card(rec: Optional[dict]) -> Optional[str]:
    """``"<card name>, <power limit>"`` when the record was measured on an
    NVIDIA card, else None.  Such a record has ``device`` =
    ``{"platform": "gpu", "kind": <torch.cuda.get_device_name>,
    "power_limit": <nvidia-smi's power.limit, e.g. "700.00 W">, ...}``."""
    dev = (rec or {}).get("device")
    if not isinstance(dev, dict) or dev.get("platform") != "gpu":
        return None
    kind, limit = dev.get("kind"), dev.get("power_limit")
    if not kind or "NVIDIA" not in str(kind) or not limit:
        return None
    return f"{kind}, {limit}"


def latest_artifact(repo: str) -> tuple[str, list[str]]:
    """Newest committed artifact measured on an NVIDIA card, plus the newer
    artifacts skipped on the way (TPU, CPU or a GPU record without the
    card's name and power limit)."""
    paths = sorted(glob.glob(os.path.join(repo, "BENCH_r*.json")))
    skipped = []
    for p in reversed(paths):
        if gpu_card(_record(p)):
            return p, list(reversed(skipped))
        skipped.append(os.path.basename(p))
    raise SystemExit(
        "no on-card (NVIDIA GPU, with its name and power limit) "
        "BENCH_r*.json artifact found"
        + (f"; skipped: {', '.join(reversed(skipped))}" if skipped else ""))


def render_table(path: str, skipped_non_gpu: list[str] | None = None) -> str:
    b = _record(path)
    card = gpu_card(b)
    if card is None:
        raise SystemExit(f"{os.path.basename(path)} records no NVIDIA card "
                         "with its name and power limit")
    name = os.path.basename(path)
    caption = ""
    if skipped_non_gpu:
        caption = (" — newer artifact(s) not measured on an NVIDIA card "
                   "skipped: " + ", ".join(skipped_non_gpu))
    unit = b.get("unit", "")
    rows = [f"| `{k}` | **{v}**{' ' + unit if k == 'value' and unit else ''} |"
            for k, v in b.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    body = "\n".join(rows)
    return (f"{START} (generated by python -m aegis_tpu_torch.tools."
            f"bench_table from {name} — do not hand-edit) -->\n"
            f"| Metric (from `{name}`, {card}{caption}) | Recorded |\n"
            f"|---|---|\n{body}\n{END}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    write = "--write" in argv
    argv = [a for a in argv if a != "--write"]
    readme = os.path.join(REPO, "README.md")
    with open(readme) as f:
        src = f.read()
    pat = re.compile(re.escape(START) + r".*?" + re.escape(END), re.S)
    if not pat.search(src):
        raise SystemExit("README.md has no TORCH_BENCH_TABLE markers")
    if argv:
        path, skipped = argv[0], []
    else:
        path, skipped = latest_artifact(REPO)
    table = render_table(path, skipped)
    if write:
        with open(readme, "w") as f:
            f.write(pat.sub(lambda _m: table, src))
        print(f"README.md port table regenerated from {os.path.basename(path)}")
    else:
        print(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
