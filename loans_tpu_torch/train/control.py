"""Runtime training control: a stdin REPL and a control file (port of
``loans_tpu/train/control.py``).

Commands (``shiftlr <factor>``, ``setlr <lr>``, ``quit``,
``enablebboxvis``, ``echo ...``) come from lines appended to
``<log_dir>/control`` and, with ``use_stdin``, from standard input; the
trainer applies them at the next step-call boundary. A learning-rate
change takes effect at the next optimizer update, with nothing rebuilt.
In data-parallel training only rank 0 drains its channel and broadcasts
what it drained (``train.loop.Trainer``), so every rank applies the same
commands at the same iteration.
"""

from __future__ import annotations

import os
import sys
import threading
from queue import Empty, Queue


class CommandChannel:
    """Merged command stream from a stdin REPL and a control file."""

    def __init__(self, log_dir: str | None = None, use_stdin: bool = False):
        self._queue: Queue[str] = Queue()
        self._control_path = os.path.join(log_dir, "control") if log_dir else None
        self._consumed = 0
        if use_stdin and sys.stdin is not None:
            threading.Thread(target=self._stdin_loop, daemon=True).start()

    def _stdin_loop(self):
        try:
            for line in sys.stdin:
                self._queue.put(line.strip())
        except (OSError, ValueError):  # stdin closed under the thread
            pass

    def _poll_file(self):
        if not self._control_path or not os.path.exists(self._control_path):
            return
        try:
            with open(self._control_path) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        except OSError:
            return
        for line in lines[self._consumed :]:
            self._queue.put(line)
        self._consumed = len(lines)

    def drain(self) -> list[str]:
        """Every command that arrived since the last call, in order."""
        self._poll_file()
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except Empty:
                return out


def apply_commands(commands: list[str], trainer) -> None:
    """Execute control commands against a running ``Trainer``."""
    for cmd in commands:
        parts = cmd.split()
        if not parts:
            continue
        op, args = parts[0].lower(), parts[1:]
        if op == "shiftlr" and args:
            trainer.shift_learning_rate(float(args[0]))
        elif op == "setlr" and args:
            trainer.set_learning_rate(float(args[0]))
        elif op == "quit":
            trainer.request_stop()
        elif op == "enablebboxvis":
            trainer.enable_bbox_vis()
        elif op == "echo":
            print(" ".join(args))
        else:
            print(f"unknown control command: {cmd!r}")
