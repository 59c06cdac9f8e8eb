"""Tagged structured logging.

The reference logs with emoji/tag prefixes on stdout ([Aegis], [Financial],
[Harmonic], ... — SURVEY.md §5.5).  Here the same tags flow through the
standard logging module so hosts can route/structure them.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(name)s] %(message)s"
_configured = False


def get_logger(tag: str) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("aegis")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"aegis.{tag}" if not tag.startswith("aegis") else tag)
