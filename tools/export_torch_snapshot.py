"""Export a JAX training log dir's snapshots for the PyTorch port.

Reads the latest ``Localizer_<iter>.msgpack`` and
``ResnetAssessor_<iter>.msgpack`` of a ``loans_tpu`` log dir (names from
``manifest.json``'s ``snapshot_names``), maps their ``params`` and
``batch_stats`` onto the port's models through ``loans_tpu_torch.bridge``
and writes ``<Name>_<iter>.pt`` beside them, so that
``loans_tpu_torch.inference.LocalizerInference`` can serve the model on a
GPU. Needs both packages (run it where JAX and flax are installed):

    python tools/export_torch_snapshot.py <log_dir>
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flax import serialization  # noqa: E402

from loans_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from loans_tpu_torch import bridge  # noqa: E402
from loans_tpu_torch.train import checkpoint  # noqa: E402
from loans_tpu_torch.utils.registry import build_assessor, build_model  # noqa: E402


def export(log_dir: str) -> list[str]:
    """Write ``.pt`` snapshots for the latest localizer and assessor
    ``.msgpack`` snapshots of ``log_dir``; returns the paths written."""
    manifest = jax_checkpoint.load_manifest(log_dir)
    names = manifest.get("snapshot_names", ["Localizer", "ResnetAssessor"])
    loc_cfg = manifest["localizer"]
    localizer = build_model(loc_cfg["model"], **loc_cfg["kwargs"])
    models = {names[0]: localizer}
    if "assessor" in manifest and len(names) > 1:
        models[names[-1]] = build_assessor(manifest["assessor"], localizer)
    written = []
    for name, model in models.items():
        snaps = jax_checkpoint.list_snapshots(log_dir, name + "_")
        if not snaps:
            raise FileNotFoundError(f"no {name}_*.msgpack snapshots in {log_dir}")
        iteration, path = snaps[-1]
        with open(path, "rb") as f:
            raw = serialization.msgpack_restore(f.read())
        state = bridge.to_state_dict(
            model, raw.get("params", raw), raw.get("batch_stats") or None
        )
        out = os.path.join(log_dir, checkpoint.snapshot_name(name, iteration))
        written.append(checkpoint.save_params(out, state))
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("log_dir", help="loans_tpu training log dir")
    args = p.parse_args(argv)
    written = export(args.log_dir)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
