"""Localizer: backbone + affine-param head + STN crop (port of
``loans_tpu/models/localizer.py``).

* Preprocessing is x*255 - ImageNet mean (RGB order).
* The extra ``res6``/``res7`` stages exist when the static ``input_size``
  is above 224 / 300.
* The head ``param_predictor`` starts with zero weights and bias
  [0.8, 0, 0, 0, 0.8, 0]: a centered 0.8-scale axis-aligned crop.
* Rotation dropout, then the crop, then optional grayscale (standard luma
  0.299 R + 0.587 G + 0.114 B, as in the JAX package).

VisualBackprop: ``forward`` and ``predict_theta`` take an optional list
``vbp``, which receives the backbone's recorded inputs (see
``models/resnet.py``), ``res6``'s and ``res7``'s, and last the anchor, the
(N, C, h, w) feature map the head pools (the JAX package's
``vbp_anchor``); ``vbp_ladder()`` gives the matching static ladder.

``sampler="auto"`` at ``rotation_dropout_ratio == 0`` crops with the CUDA
kernels (``method="pallas"``) for CUDA tensors and with their plain
PyTorch version (``method="separable"``) for CPU tensors, where no kernel
can run; at other ratios it uses the gather path (``"general"``), as the
JAX package's ``auto`` does. The rotated crop's kernels run when a
localizer names them: ``sampler="rotated_pallas"`` (CUDA tensors), or
``"rotated"`` for their plain version.
"""

from __future__ import annotations

import torch
from torch import nn

from loans_tpu_torch.models.resnet import (
    BasicStage,
    BottleNeckStage,
    ResNet,
    resnet_vbp_ladder,
    set_dtypes,
    stage_ladder,
)
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.ops.rotation_dropout import rotation_dropout
from loans_tpu_torch.ops.stn import spatial_transform
from loans_tpu_torch.utils.constants import device_table

# ImageNet channel means, RGB order, for x*255 inputs.
IMAGENET_MEAN_RGB = (123.68, 116.779, 103.939)
HEAD_BIAS = (0.8, 0.0, 0.0, 0.0, 0.8, 0.0)
GRAYSCALE_WEIGHTS = (0.299, 0.587, 0.114)


class Localizer(nn.Module):
    """Backbone + 6-param affine head + STN crop.

    Args:
      out_size: crop size fed to the assessor.
      n_layers: backbone ResNet variant.
      input_size: static input size; enables res6 (>224) and res7 (>300).
      rotation_dropout_ratio: see ``ops/rotation_dropout``.
      sampler: 'auto' | 'separable' | 'pallas' | 'rotated' |
        'rotated_pallas' | 'general' (see ``ops.stn.spatial_transform``).
      transform_rois_to_grayscale: collapse crops to 1 channel.
      dtype: the backbone's compute dtype (float32 or bfloat16);
        parameters stay float32.
      norm_dtype: the dtype of the BatchNorms' outputs (they compute in
        float32).

    The head, theta and the crop stay float32 whatever ``dtype``: the
    crop reads the un-cast images, so K1 remains a float32 kernel.
    """

    def __init__(
        self,
        out_size: Size = Size(75, 75),
        n_layers: int = 50,
        input_size: Size = Size(224, 224),
        rotation_dropout_ratio: float = 0.0,
        sampler: str = "auto",
        transform_rois_to_grayscale: bool = False,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.out_size = Size(*out_size)
        self.n_layers = n_layers
        self.input_size = Size(*input_size)
        self.rotation_dropout_ratio = rotation_dropout_ratio
        self.sampler = sampler
        self.transform_rois_to_grayscale = transform_rois_to_grayscale
        self.feature_extractor = ResNet(n_layers)
        ch = self.feature_extractor.feature_dim
        if self.input_size.height > 224:
            self.res6 = self._extra_stage(ch)
            if self.input_size.height > 300:
                self.res7 = self._extra_stage(ch)
        self.param_predictor = nn.Linear(ch, 6)
        nn.init.zeros_(self.param_predictor.weight)
        with torch.no_grad():
            self.param_predictor.bias.copy_(torch.tensor(HEAD_BIAS))
        self.register_buffer(
            "mean", torch.tensor(IMAGENET_MEAN_RGB), persistent=False
        )
        set_dtypes(self, dtype, norm_dtype)

    def _extra_stage(self, ch: int) -> nn.Module:
        if self.n_layers in (18, 34):
            return BasicStage(ch, 2, 512, 2)
        return BottleNeckStage(ch, 2, 1024, 2048, 2)

    def sampler_method(self, images: torch.Tensor) -> str:
        """The ``spatial_transform`` method this call crops with."""
        if self.sampler != "auto":
            return self.sampler
        if self.rotation_dropout_ratio != 0.0:
            return "general"
        return "pallas" if images.is_cuda else "separable"

    def features(self, images: torch.Tensor, vbp: list | None = None) -> torch.Tensor:
        """The (N, C, h, w) feature map the head pools, of ``images`` (N,
        H, W, 3) RGB in [0, 1], NHWC: the backbone and ``res6``/``res7``.
        In train mode it updates their BatchNorm statistics and draws
        nothing."""
        x = (images * 255.0 - self.mean.to(images.dtype)).permute(0, 3, 1, 2)
        dtype = self.feature_extractor.Conv_0.compute_dtype
        if dtype is not None:  # the JAX Localizer casts before its backbone
            x = x.to(dtype)
        h = self.feature_extractor(x, vbp)
        if hasattr(self, "res6"):
            h = self.res6(h, vbp)
        if hasattr(self, "res7"):
            h = self.res7(h, vbp)
        return h

    def predict_theta(
        self,
        images: torch.Tensor,
        generator: torch.Generator | None = None,
        vbp: list | None = None,
    ) -> torch.Tensor:
        """The (N, 2, 3) affine params of ``images`` (N, H, W, 3) RGB in
        [0, 1], NHWC, without the crop; ``generator`` draws rotation
        dropout in train mode at 0 < ratio < 1."""
        h = self.features(images, vbp)
        if vbp is not None:
            vbp.append(h)
        h = h.mean(dim=(2, 3))  # global average pool
        theta = self.param_predictor(h.float()).reshape(-1, 2, 3)
        return rotation_dropout(
            theta,
            self.rotation_dropout_ratio,
            train=self.training,
            generator=generator,
        )

    def forward(
        self,
        images: torch.Tensor,
        generator: torch.Generator | None = None,
        vbp: list | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Args:
          images: (N, H, W, 3) RGB in [0, 1], NHWC.
          generator: rotation-dropout draw in train mode at 0 < ratio < 1.
          vbp: a list to record VisualBackprop's inputs and anchor in.

        Returns:
          (rois, theta): (N, out_h, out_w, C) crops of the *unnormalized*
          images, and the (N, 2, 3) affine params.
        """
        theta = self.predict_theta(images, generator, vbp)
        rois = spatial_transform(
            images, theta, self.out_size, method=self.sampler_method(images)
        )
        if self.transform_rois_to_grayscale:
            if rois.shape[-1] != 3:
                raise ValueError("rois are not in RGB, can not convert them to grayscale")
            weights = device_table(GRAYSCALE_WEIGHTS, rois.dtype, rois.device)
            rois = (rois * weights).sum(dim=-1, keepdim=True)
        return rois, theta

    def vbp_ladder(self) -> tuple[tuple, ...]:
        return localizer_vbp_ladder(self.n_layers, self.input_size)


def localizer_vbp_ladder(n_layers: int, input_size: Size) -> tuple[tuple, ...]:
    """The static VisualBackprop ladder of a localizer configuration (port
    of ``loans_tpu.models.localizer.localizer_vbp_ladder``): the backbone's,
    then ``res6``'s above 224 and ``res7``'s above 300."""
    steps = list(resnet_vbp_ladder(n_layers))
    extra = stage_ladder(2, 2, bottleneck=n_layers not in (18, 34))
    if input_size.height > 224:
        steps.extend(extra)
        if input_size.height > 300:
            steps.extend(extra)
    return tuple(steps)
