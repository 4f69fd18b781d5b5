"""Log-dir snapshots and manifest (the serving subset of
``loans_tpu/train/checkpoint.py``).

A log dir holds ``manifest.json`` (registry names + kwargs of each model,
the same file the JAX package writes) and one snapshot per model and
iteration. The port's snapshots are ``<Name>_<iteration>.pt``: a
``torch.save`` of the model's ``state_dict``. ``tools/export_torch_snapshot.py``
writes them from the JAX package's ``.msgpack`` snapshots.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch


def save_params(path: str, state_dict: dict[str, torch.Tensor]) -> str:
    """Write a model snapshot atomically (tmp + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_params(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Read a snapshot written by ``save_params`` (tensors only)."""
    return torch.load(path, map_location=device, weights_only=True)


def snapshot_name(model_name: str, iteration: int) -> str:
    return f"{model_name}_{iteration}.pt"


_SNAP_RE = re.compile(r"_(\d+)\.pt$")


def list_snapshots(log_dir: str, prefix: str) -> list[tuple[int, str]]:
    """(iteration, path) for all ``<prefix>*_<iter>.pt``, sorted by
    iteration."""
    out = []
    if not os.path.isdir(log_dir):
        return out
    for fname in os.listdir(log_dir):
        if not fname.startswith(prefix):
            continue
        m = _SNAP_RE.search(fname)
        if m:
            out.append((int(m.group(1)), os.path.join(log_dir, fname)))
    return sorted(out)


def save_manifest(log_dir: str, manifest: dict[str, Any]) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, default=_json_default)
    return path


def load_manifest(log_dir: str) -> dict[str, Any]:
    with open(os.path.join(log_dir, "manifest.json")) as f:
        return json.load(f)


def _json_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "_asdict"):
        return list(obj)
    return str(obj)
