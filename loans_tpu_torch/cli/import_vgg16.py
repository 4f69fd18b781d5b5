"""Convert pretrained VGG16 weights into the SSD backbone's
``--pretrained-model`` file (port of ``tools/import_vgg16.py``).

    python -m loans_tpu_torch.cli.import_vgg16 vgg16.pth out.pt
    python -m loans_tpu_torch.cli.train_ssd ... --pretrained-model out.pt

The reference's SSD300/512 starts from an ImageNet VGG16
(``schaaaafrichter/train.py:138-147``, ``pretrained_model='imagenet'``).
This tool maps a torchvision ``vgg16`` ``state_dict`` onto the port's
``VGG16Extractor_0`` keys (``models/ssd.py``; ``train.checkpoint.save_params``):

  * ``features.{0,2,5,7,10,12,14,17,19,21,24,26,28}`` -> ``Conv_0`` ..
    ``Conv_12``;
  * ``classifier.0`` (fc6) -> the atrous ``Conv_13`` by SSD's subsampling:
    viewed as (4096, 512, 7, 7), output channels ``[0::4]`` (1024) and taps
    ``[0::3]`` (3x3);
  * ``classifier.3`` (fc7) -> the 1x1 ``Conv_14``: channels ``[0::4]``
    both ways.

``L2Norm_0`` and the extra and multibox layers keep their init. No weights
are downloaded: the checkpoint must already be on disk.
"""

from __future__ import annotations

import argparse
from collections.abc import Mapping

import torch

from loans_tpu_torch.cli.import_resnet50 import float32_tensor

# torchvision ``features`` indices of the 13 convolutions, in order
FEATURE_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
PREFIX = "VGG16Extractor_0."


def convert_vgg16(state: Mapping) -> dict[str, torch.Tensor]:
    """torchvision ``vgg16`` ``state_dict`` -> ``VGG16Extractor_0``'s 15
    convolutions (weights OIHW, biases)."""
    out = {}
    for i, idx in enumerate(FEATURE_CONVS):
        out[f"{PREFIX}Conv_{i}.weight"] = float32_tensor(state[f"features.{idx}.weight"])
        out[f"{PREFIX}Conv_{i}.bias"] = float32_tensor(state[f"features.{idx}.bias"])
    w6 = float32_tensor(state["classifier.0.weight"]).reshape(4096, 512, 7, 7)
    out[f"{PREFIX}Conv_13.weight"] = w6[0::4, :, 0::3, 0::3].contiguous()  # (1024, 512, 3, 3)
    out[f"{PREFIX}Conv_13.bias"] = float32_tensor(state["classifier.0.bias"])[0::4].contiguous()
    w7 = float32_tensor(state["classifier.3.weight"]).reshape(4096, 4096, 1, 1)
    out[f"{PREFIX}Conv_14.weight"] = w7[0::4, 0::4].contiguous()  # (1024, 1024, 1, 1)
    out[f"{PREFIX}Conv_14.bias"] = float32_tensor(state["classifier.3.bias"])[0::4].contiguous()
    return out


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert a torchvision VGG16 into the SSD backbone's "
                                            "--pretrained-model file")
    p.add_argument("checkpoint", help="torchvision vgg16 .pth state_dict")
    p.add_argument("output", help="output .pt (a state_dict under SSD's VGG16Extractor_0 keys)")
    return p


def main(argv=None) -> str:
    """Convert and write ``output``; returns it."""
    from loans_tpu_torch.train import checkpoint

    args = get_parser().parse_args(argv)
    state_dict = convert_vgg16(torch.load(args.checkpoint, map_location="cpu", weights_only=True))
    checkpoint.save_params(args.output, state_dict)
    n = sum(v.numel() for v in state_dict.values())
    print(f"wrote {args.output} ({n / 1e6:.1f}M params)")
    return args.output


if __name__ == "__main__":
    main()
