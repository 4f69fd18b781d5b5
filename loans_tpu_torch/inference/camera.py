"""Camera and audio helpers of the live demo (port of
``loans_tpu/inference/camera.py``).

``Camera`` is a context manager over ``cv2.VideoCapture`` (imported when
the camera opens): a device index or a video file's path, read at its own
size. ``AudioRenderer`` plays a wav with ``aplay`` on a daemon thread when
signalled, at most once per ``min_interval`` seconds; without ``aplay`` it
stays silent.
"""

from __future__ import annotations

import subprocess
import threading


class Camera:
    """``with Camera(0) as cam: frame = cam.get_frame()`` (BGR uint8)."""

    def __init__(self, device: int | str = 0):
        self.device = device
        self._cap = None

    def __enter__(self):
        import cv2

        self._cap = cv2.VideoCapture(self.device)
        if not self._cap.isOpened():
            raise RuntimeError(f"could not open camera {self.device}")
        return self

    def get_frame(self):
        ok, frame = self._cap.read()
        if not ok:
            raise RuntimeError("camera read failed")
        return frame

    def __exit__(self, *exc):
        if self._cap is not None:
            self._cap.release()
        return False


class AudioRenderer:
    """Play a wav on demand from a daemon thread, rate-limited."""

    def __init__(self, wav_path: str, min_interval: float = 1.0):
        self.wav_path = wav_path
        self.min_interval = min_interval
        self.enabled = True
        self._event = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def play(self):
        if self.enabled:
            self._event.set()

    def toggle(self):
        self.enabled = not self.enabled

    def _loop(self):
        while not self._stop.is_set():
            if self._event.wait(timeout=0.1):
                self._event.clear()
                try:
                    subprocess.run(["aplay", "-q", self.wav_path], timeout=10, check=False, capture_output=True)
                except (OSError, subprocess.SubprocessError):
                    pass  # no aplay: silent
                self._stop.wait(self.min_interval)

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
