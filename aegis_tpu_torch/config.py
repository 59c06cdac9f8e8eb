"""Typed configuration, re-exported from ``aegis_tpu/config.py`` (pure
Python): both packages run from the same frozen dataclasses."""

from aegis_tpu.config import AudioConfig, PyinConfig, TurboConfig  # noqa: F401
