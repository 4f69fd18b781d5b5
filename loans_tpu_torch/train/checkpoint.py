"""Log-dir snapshots and manifest (port of ``loans_tpu/train/checkpoint.py``).

A log dir holds ``manifest.json`` (registry names + kwargs of each model,
the same file the JAX package writes) and one snapshot per model and
iteration, ``<Name>_<iteration>.pt``: either a ``torch.save`` of the
model's ``state_dict`` (``save_params``; ``tools/export_torch_snapshot.py``
writes these from the JAX package's ``.msgpack`` snapshots) or a training
snapshot ``{"step", "params": state_dict, "optimizer": optimizer state}``
(``save_state``). ``load_params`` reads both, so a log dir that the
trainer wrote serves as it is. Writes are atomic (tmp + rename).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterable

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
    """The model ``state_dict`` of a snapshot written by ``save_params``
    or ``save_state``."""
    payload = torch.load(path, map_location=device, weights_only=True)
    return payload["params"] if _is_training_snapshot(payload) else payload


def _is_training_snapshot(payload: dict) -> bool:
    return "params" in payload and "optimizer" in payload


def save_state(path: str, state) -> str:
    """Write a ``TrainState``'s step, model ``state_dict`` and optimizer
    state atomically. The EMA copy is not saved: a restored state takes a
    fresh one (``TrainState.with_ema``), as in the JAX package."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "step": int(state.step),
        "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_state(path: str, state):
    """Load a ``save_state`` snapshot into ``state``'s model and optimizer
    (strict) and set its step; returns ``state``."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    if not _is_training_snapshot(payload):
        raise ValueError(f"{path} is a params-only snapshot, not a training snapshot")
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def restore_params(path: str, model: torch.nn.Module, skip_prefixes: Iterable[str] = ()) -> list[str]:
    """Partial restore (port of ``restore_params``, ``loans_tpu/train/
    checkpoint.py:78-120``): load the snapshot's entries into ``model``
    where the key and the shape match, and keep ``model``'s own values
    elsewhere and under ``skip_prefixes`` (module paths, ``.`` or ``/``
    joined: ``('param_predictor',)`` transfers a backbone and keeps the
    fresh head). Returns the keys loaded."""
    loaded = load_params(path, device="cpu")
    skip = tuple(p.replace("/", ".") for p in skip_prefixes if p)
    target = model.state_dict()
    taken = []
    with torch.no_grad():
        for key, value in target.items():
            if any(key == p or key.startswith(p + ".") for p in skip):
                continue
            if key in loaded and tuple(loaded[key].shape) == tuple(value.shape):
                value.copy_(loaded[key].to(value.dtype))
                taken.append(key)
    return taken


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
