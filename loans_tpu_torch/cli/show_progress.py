"""Live training-image viewer (port of ``loans_tpu/cli/show_progress.py``).

    python -m loans_tpu_torch.cli.show_progress --port 1337 --save-dir frames/

A TCP server (``insights.progress_server.ImageServer``) receives the
BBoxPlotter's frames (the training CLIs' ``--send-bboxes HOST:PORT``) and
shows them in a tkinter window where a display exists; with
``--headless``, or without ``DISPLAY``, it only receives (and saves with
``--save-dir``) until interrupted. Needs neither Pillow nor a card.
"""

from __future__ import annotations

import argparse
import os
import time


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="live training image viewer")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", "-p", type=int, default=1337)
    p.add_argument("--save-dir", default=None, help="also save every received frame here")
    p.add_argument("--headless", action="store_true", help="no window; requires --save-dir")
    return p


def main(argv=None):
    from loans_tpu_torch.insights.progress_server import ImageServer

    args = get_parser().parse_args(argv)
    show = not args.headless and bool(os.environ.get("DISPLAY"))
    server = ImageServer(args.host, args.port, save_dir=args.save_dir, show_window=show)
    print(f"listening on {args.host}:{args.port}")
    server.start()
    if not show:  # the server runs on a daemon thread: wait here
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            server.stop()


if __name__ == "__main__":
    main()
