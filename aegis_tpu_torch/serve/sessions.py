"""Thread-safe session store for the API server. A copy of
``aegis_tpu/serve/sessions.py`` (no JAX in it), held equal to it by
``tests/test_torch_server.py``.

The reference keeps sessions in a bare dict mutated without locks, safe only
because uvicorn runs one event loop (server.py:53-61, SURVEY.md §5.2).  This
server is threaded, so the store locks, and sessions can optionally persist
their heavy raw_data to disk (.npz) so a restarted server can resume
(SURVEY.md §5.4 checkpoint/resume).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np


class SessionStore:
    def __init__(self, persist_dir: Optional[str] = None, ttl: float = 3600.0):
        self._lock = threading.Lock()
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._persist_dir = persist_dir
        self._ttl = ttl
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)

    def create(self, **fields) -> str:
        with self._lock:
            # 16 hex = 64 bits; the regenerate loop makes an accidental
            # collision (which would hand one user another's session)
            # impossible rather than merely unlikely
            sid = uuid.uuid4().hex[:16]
            while sid in self._sessions:
                sid = uuid.uuid4().hex[:16]
            self._sessions[sid] = {"_created": time.time(), "_touched": time.time(),
                                   **fields}
        return sid

    def get(self, sid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                sess["_touched"] = time.time()
            return sess

    def update(self, sid: str, **fields) -> None:
        with self._lock:
            if sid in self._sessions:
                # a write IS activity: without the touch, a session only
                # being written to (a long analysis that never get()s)
                # could be swept mid-processing and lose its results
                self._sessions[sid]["_touched"] = time.time()
                self._sessions[sid].update(fields)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def sweep(self) -> int:
        """Drop sessions idle past the TTL, deleting their on-disk artifacts
        (uploaded audio, persisted raw_data checkpoint); returns the number
        removed."""
        now = time.time()
        with self._lock:
            stale = [s for s, v in self._sessions.items()
                     if now - v["_touched"] > self._ttl]
            evicted = [self._sessions.pop(s) for s in stale]
        for sid, sess in zip(stale, evicted):
            for path in (sess.get("file_path"),
                         os.path.join(self._persist_dir, f"{sid}.npz")
                         if self._persist_dir else None):
                if path and os.path.exists(path):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        return len(stale)

    # ------------------------------------------------------------ persistence

    def checkpoint_raw(self, sid: str) -> Optional[str]:
        """Persist a session's raw_data to disk; returns the path."""
        if not self._persist_dir:
            return None
        sess = self.get(sid)
        if not sess or sess.get("raw_data") is None:
            return None
        path = os.path.join(self._persist_dir, f"{sid}.npz")
        np.savez_compressed(path, **sess["raw_data"])
        return path

    def restore_raw(self, sid: str) -> bool:
        if not self._persist_dir:
            return False
        path = os.path.join(self._persist_dir, f"{sid}.npz")
        if not os.path.exists(path):
            return False
        with np.load(path, allow_pickle=False) as z:
            raw = {k: z[k] for k in z.files}
        with self._lock:
            self._sessions.setdefault(sid, {"_created": time.time(),
                                            "_touched": time.time()})
            self._sessions[sid]["raw_data"] = raw
        return True
