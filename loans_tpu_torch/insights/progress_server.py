"""Live training images over TCP: a sender and a receiving server (port of
``loans_tpu/insights/progress_server.py``), without Pillow.

The wire format is the JAX package's: one JSON object per connection,
``{"width", "height", "channels", "title", "image": <base64 PNG>}``.
``ImageClient.send`` encodes an HW3 uint8 array with
``insights.rendering.encode_png`` and sends it with a 1 s connection
timeout; a refused or failed connection disables the client until
``enable_send`` (the training CLI's ``enablebboxvis`` command). ``ImageServer``
receives on a thread, decodes with ``data/png.py``, keeps the newest frame,
calls ``on_image(image, title)``, saves each frame as
``<save_dir>/<count:06d>.png`` with ``write_png`` and, with
``show_window``, shows it in a tkinter window (imported when the window
opens; tkinter reads the PNG itself).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import threading
from typing import Callable

import numpy as np

from loans_tpu_torch.data.png import decode_png
from loans_tpu_torch.insights.rendering import encode_png, write_png

DEFAULT_PORT = 1337


class ImageClient:
    """Sends one frame per connection; disabled by a refused connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.host = host
        self.port = port
        self.enabled = True

    def enable_send(self):
        self.enabled = True

    def send(self, image: np.ndarray, title: str = "") -> bool:
        """Send an HW3 uint8 image; False if disabled or not delivered."""
        if not self.enabled:
            return False
        image = np.asarray(image)
        payload = json.dumps({
            "width": image.shape[1],
            "height": image.shape[0],
            "channels": image.shape[2] if image.ndim == 3 else 1,
            "title": title,
            "image": base64.b64encode(encode_png(image)).decode("ascii"),
        }).encode("utf-8")
        try:
            with socket.create_connection((self.host, self.port), timeout=1.0) as s:
                s.sendall(payload)
            return True
        except OSError:
            self.enabled = False  # until enable_send
            return False


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        chunks = []
        while True:
            data = self.request.recv(65536)
            if not data:
                break
            chunks.append(data)
        try:
            msg = json.loads(b"".join(chunks).decode("utf-8"))
            img = decode_png(base64.b64decode(msg["image"]), "RGB")
        except Exception:  # a malformed frame is dropped; the server goes on
            return
        self.server.owner._on_image(img, msg.get("title", ""))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ImageServer:
    """Threaded receiver: newest frame, count, callback, optional save
    directory and tkinter window. Port 0 takes a free port (``port``)."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = DEFAULT_PORT,
        on_image: Callable[[np.ndarray, str], None] | None = None,
        save_dir: str | None = None,
        show_window: bool = False,
    ):
        self.on_image = on_image
        self.save_dir = save_dir
        self.show_window = show_window
        self.latest: np.ndarray | None = None
        self.count = 0
        self._lock = threading.Lock()
        self._server = _Server((host, port), _Handler)
        self._server.owner = self
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._pending: tuple[np.ndarray, str] | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self):
        """Serve on a thread; with ``show_window``, run the window here
        (blocks until it is closed)."""
        self._thread.start()
        if self.show_window:
            self._run_window()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    def _on_image(self, img: np.ndarray, title: str):
        with self._lock:
            self.latest = img
            self.count += 1
            if self.save_dir:
                os.makedirs(self.save_dir, exist_ok=True)
                write_png(os.path.join(self.save_dir, f"{self.count:06d}.png"), img)
            if self.on_image is not None:
                self.on_image(img, title)
            self._pending = (img, title)

    def _run_window(self):
        """The tkinter viewer: shows the newest frame every 100 ms."""
        import tkinter as tk

        root = tk.Tk()
        root.title("training progress")
        label = tk.Label(root)
        label.pack()

        def tick():
            with self._lock:
                pending, self._pending = self._pending, None
            if pending is not None:
                img, title = pending
                photo = tk.PhotoImage(data=base64.b64encode(encode_png(img)).decode("ascii"))
                label.configure(image=photo)
                label.image = photo
                if title:
                    root.title(title)
            root.after(100, tick)

        tick()
        root.mainloop()
