"""JSON metrics log, reference-compatible (port of
``loans_tpu/train/logger.py`` without its tensorboard writer).

The log file is a JSON list of per-interval dicts, with the full train
config folded into the FIRST entry; downstream tools treat ``log[0]`` as
the config source of truth.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLog:
    """Append-only JSON-list log with config-enriched first entry."""

    def __init__(
        self,
        log_dir: str,
        config: dict[str, Any] | None = None,
        log_name: str = "log",
    ):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, log_name)
        self.entries: list[dict[str, Any]] = []
        self._config = dict(config or {})
        self._start = time.time()

    def append(self, metrics: dict[str, Any]) -> None:
        entry = {
            k: (float(v) if _is_scalar(v) else v) for k, v in metrics.items()
        }
        entry.setdefault("elapsed_time", time.time() - self._start)
        if not self.entries and self._config:
            entry.update(self._config)
        self.entries.append(entry)
        self.flush()

    def flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.entries, f, indent=2, default=str)
        os.replace(tmp, self.path)

    @staticmethod
    def read(log_dir_or_path: str) -> list[dict[str, Any]]:
        path = log_dir_or_path
        if os.path.isdir(path):
            path = os.path.join(path, "log")
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def read_config(log_dir_or_path: str) -> dict[str, Any]:
        """Config = first log entry (reference contract)."""
        entries = MetricsLog.read(log_dir_or_path)
        return entries[0] if entries else {}


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
