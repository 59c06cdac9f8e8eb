"""Audio I/O, re-exported from ``aegis_tpu/io`` (pure NumPy), so the
port's scripts name only this package."""

from aegis_tpu.io import load_audio, read_wav, write_wav  # noqa: F401
