"""Weights carried across: JAX/flax variables <-> PyTorch ``state_dict``.

The port's modules carry the flax module names of the JAX package, so a
flax leaf ``<module path>/<leaf>`` maps to the ``state_dict`` key
``<module path with '.'>.<torch leaf>``:

==========================  ===================  ======================
flax leaf                   torch leaf           value
==========================  ===================  ======================
``Conv_k/kernel`` (4-D)     ``weight``           HWIO -> OIHW
``Dense/kernel`` (2-D)      ``weight``           transposed
``bias``                    ``bias``             as is
``BatchNorm_k/scale``       ``weight``           as is
``L2Norm_0/scale`` (SSD)    ``weight``           as is
batch_stats ``mean``        ``running_mean``     as is
batch_stats ``var``         ``running_var``      as is
==========================  ===================  ======================

BatchNorm's ``num_batches_tracked`` counters, which flax does not keep,
are set to 0. A missing or extra key, or a shape mismatch against the
target model, raises: there is no partial load.

Variables come as nested dicts (as ``flax.serialization.msgpack_restore``
or ``Module.init`` give them) or as flat dicts keyed by ``/``-joined
paths, with numpy arrays (or anything ``np.asarray`` takes) as leaves.

``from_state_dict`` is the inverse: a ``state_dict`` back to flax's nested
``params`` and ``batch_stats`` as numpy arrays (no flax needed), which
``tools/import_torch_snapshot.py`` writes as the JAX package's snapshots.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def flatten_variables(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested or ``/``-joined dict of arrays -> flat ``{path: array}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_variables(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, leaf = path.split("/")
    if leaf not in _LEAF_NAMES or not modules:
        raise KeyError(f"no PyTorch counterpart for flax leaf {path!r}")
    if leaf == "kernel" and value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and value.ndim == 2:
        value = value.T
    return ".".join(modules) + "." + _LEAF_NAMES[leaf], value


def torch_leaves(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, np.ndarray]:
    """Every flax leaf of ``params`` (and ``batch_stats``) under its
    ``state_dict`` key, in PyTorch's layout, with no model to check them
    against (a stripped snapshot's subset too)."""
    leaves = {}
    for collection in (params, batch_stats or {}):
        for path, value in flatten_variables(collection).items():
            key, value = _torch_leaf(path, value)
            if key in leaves:
                raise KeyError(f"{key!r} given twice")
            leaves[key] = value
    return leaves


def to_state_dict(
    model: nn.Module,
    params: Mapping,
    batch_stats: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """Map flax ``params`` (and ``batch_stats``) onto ``model``'s keys.

    Returns a complete ``state_dict`` for ``model`` on the CPU, in
    ``model``'s dtypes; raises ``KeyError`` on missing or extra keys and
    ``ValueError`` on shape mismatches.
    """
    target = model.state_dict()
    leaves = torch_leaves(params, batch_stats)
    expected = {k for k in target if not k.endswith("num_batches_tracked")}
    missing = sorted(expected - leaves.keys())
    extra = sorted(leaves.keys() - expected)
    if missing or extra:
        raise KeyError(f"flax variables do not fit the model: missing {missing}, extra {extra}")
    out = {}
    for key, ref in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(ref, device="cpu")
            continue
        value = leaves[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: flax value is {tuple(value.shape)} in PyTorch "
                f"layout, the model has {tuple(ref.shape)}"
            )
        out[key] = torch.tensor(np.ascontiguousarray(value), dtype=ref.dtype)
    return out


def localizer_state_dict(
    model: nn.Module, params: Mapping, batch_stats: Mapping
) -> dict[str, torch.Tensor]:
    """``state_dict`` for a port ``Localizer`` from the JAX Localizer's
    ``params`` and ``batch_stats``."""
    return to_state_dict(model, params, batch_stats)


def assessor_state_dict(model: nn.Module, params: Mapping) -> dict[str, torch.Tensor]:
    """``state_dict`` for a port ``ResnetAssessor`` from the JAX
    ResnetAssessor's ``params`` (it has no batch statistics)."""
    return to_state_dict(model, params)


def ssd_state_dict(model: nn.Module, params: Mapping) -> dict[str, torch.Tensor]:
    """``state_dict`` for a port ``SSD`` (``SSD300`` / ``SSD512``) from the
    JAX SSD's ``params`` (it has no batch statistics; L2Norm's ``scale``
    leaf becomes ``VGG16Extractor_0.L2Norm_0.weight``)."""
    return to_state_dict(model, params)


def from_state_dict(state_dict: Mapping) -> tuple[dict, dict]:
    """flax ``(params, batch_stats)`` of a port ``state_dict``, nested dicts
    of numpy arrays: the inverse of ``to_state_dict``. A 4-D ``weight`` is a
    convolution's kernel (OIHW -> HWIO), a 2-D one a Dense kernel
    (transposed back), a 1-D one BatchNorm's or L2Norm's ``scale``;
    ``running_mean`` and ``running_var`` go to ``batch_stats``;
    ``num_batches_tracked`` counters, which flax does not keep, are
    dropped."""
    params: dict = {}
    batch_stats: dict = {}
    for key, tensor in state_dict.items():
        *modules, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        value = tensor.detach().cpu().numpy() if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
        if not modules:
            raise KeyError(f"no flax counterpart for {key!r}")
        if leaf == "weight":
            collection, name = params, {4: "kernel", 2: "kernel", 1: "scale"}.get(value.ndim)
            if name is None:
                raise KeyError(f"no flax counterpart for a {value.ndim}-D weight {key!r}")
            if value.ndim == 4:
                value = value.transpose(2, 3, 1, 0)
            elif value.ndim == 2:
                value = value.T
        elif leaf == "bias":
            collection, name = params, "bias"
        elif leaf in ("running_mean", "running_var"):
            collection, name = batch_stats, leaf[len("running_"):]
        else:
            raise KeyError(f"no flax counterpart for {key!r}")
        node = collection
        for module in modules:
            node = node.setdefault(module, {})
        node[name] = np.ascontiguousarray(value)
    return params, batch_stats
