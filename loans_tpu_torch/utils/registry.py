"""Model registry: rebuild models from ``manifest.json`` entries
(counterpart of ``loans_tpu/utils/registry.py``)."""

from __future__ import annotations

from typing import Any, Callable

from torch import nn

from loans_tpu_torch.models import SSD300, SSD512, Localizer, ResnetAssessor
from loans_tpu_torch.ops.geometry import Size

_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "Localizer": Localizer,
    "ResnetAssessor": ResnetAssessor,
    "SSD300": SSD300,
    "SSD512": SSD512,
}


def build_model(name: str, **kwargs: Any) -> nn.Module:
    """Instantiate a registered model from manifest kwargs.

    Sizes round-trip through JSON as 2-lists and are restored to ``Size``.
    """
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; the port has {sorted(_REGISTRY)}"
        ) from None
    for key in ("out_size", "input_size", "in_size"):
        if isinstance(kwargs.get(key), (list, tuple)):
            kwargs[key] = Size(*kwargs[key])
    return factory(**kwargs)


def build_assessor(cfg: dict[str, Any], localizer: nn.Module) -> nn.Module:
    """Build a manifest's assessor entry for ``localizer``'s crops.

    The JAX assessor infers its head width from the first crops it sees;
    the port's is built for the crop size and channels up front.
    """
    return build_model(
        cfg["model"],
        in_size=localizer.out_size,
        in_ch=1 if localizer.transform_rois_to_grayscale else 3,
        **cfg["kwargs"],
    )
