"""Import a PyTorch port log dir's snapshots into the JAX package.

Reads every ``<Name>_<iter>.pt`` snapshot of a ``loans_tpu_torch`` log dir
(names from ``manifest.json``'s ``snapshot_names``; training snapshots and
model-only ones alike), maps each ``state_dict`` back to flax ``params``
and ``batch_stats`` through ``loans_tpu_torch.bridge.from_state_dict`` and
writes ``<Name>_<iter>.msgpack`` beside it, in the layout of
``loans_tpu.train.checkpoint.save_params``. The manifest is the same file
in both packages, so the JAX package then serves the log dir
(``loans_tpu.inference.LocalizerInference``) or sweeps it
(``evaluate.py``). The inverse of ``tools/export_torch_snapshot.py``;
needs both packages (run it where JAX and flax are installed):

    python tools/import_torch_snapshot.py <log_dir>
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loans_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from loans_tpu_torch import bridge  # noqa: E402
from loans_tpu_torch.train import checkpoint  # noqa: E402


def import_log_dir(log_dir: str) -> list[str]:
    """Write a ``.msgpack`` snapshot for each ``.pt`` snapshot of
    ``log_dir``; returns the paths written."""
    names = checkpoint.load_manifest(log_dir).get("snapshot_names", ["Localizer", "ResnetAssessor"])
    written = []
    for name in names:
        snaps = checkpoint.list_snapshots(log_dir, name + "_")
        if not snaps:
            raise FileNotFoundError(f"no {name}_*.pt snapshots in {log_dir}")
        for iteration, path in snaps:
            params, batch_stats = bridge.from_state_dict(checkpoint.load_params(path))
            out = os.path.join(log_dir, jax_checkpoint.snapshot_name(name, iteration))
            written.append(jax_checkpoint.save_params(out, params, batch_stats))
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("log_dir", help="loans_tpu_torch training log dir")
    args = p.parse_args(argv)
    written = import_log_dir(args.log_dir)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
