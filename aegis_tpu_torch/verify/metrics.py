"""Note-event metrics, re-exported from ``aegis_tpu/verify/metrics.py``
(pure NumPy), so the port's checks name only this package."""

from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1  # noqa: F401
