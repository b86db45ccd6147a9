"""Rotating plain-text history log (parity with ``append_history``,
``GT_FFT_v5.py:810-837``): size-capped, one ``.old`` generation kept."""

from __future__ import annotations

import os
import threading
from datetime import datetime


class HistoryLog:
    def __init__(self, path: str | os.PathLike, max_kb: int = 1024):
        self.path = str(path)
        self.max_kb = max_kb
        # Appends come from the gateway thread AND async-upload workers; the
        # lock keeps the size-check/rotate/append sequence atomic.
        self._lock = threading.Lock()

    def append(self, text: str) -> None:
        with self._lock:
            self._append_locked(text)

    def _append_locked(self, text: str) -> None:
        try:
            if os.path.exists(self.path):
                if os.path.getsize(self.path) / 1024 > self.max_kb:
                    old = self.path + ".old"
                    if os.path.exists(old):
                        os.remove(old)
                    os.rename(self.path, old)
                    with open(self.path, "w") as fh:
                        fh.write(f"--- LOG ROTATION: {datetime.now()} ---\n")
            with open(self.path, "a") as fh:
                fh.write(text)
        except Exception as exc:  # noqa: BLE001 - logging must never kill the gateway
            print(f"[CRITICAL] log error: {exc}")

    __call__ = append
