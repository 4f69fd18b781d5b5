"""Convert pretrained ResNet-50 weights into the port's ``--pretrained-model``
file (port of ``tools/import_resnet50.py``).

    python -m loans_tpu_torch.cli.import_resnet50 weights.pth out.pt --source torch --verify
    python -m loans_tpu_torch.cli.import_resnet50 ResNet-50-model.npz out.pt --source chainer

The reference's localizer starts from an ImageNet R-50
(``sheep/sheep_localizer.py:128``, ``pretrained_model='auto'``). This tool
makes that starting point from

  * a torchvision ``resnet50`` ``state_dict`` (``.pth``), or
  * a chainer ``ResNet50Layers`` npz (caffe-converted; its conv1 reads BGR,
    so its input channels are reversed to RGB here, to match the
    Localizer's preprocessing).

The output is a ``state_dict`` under the Localizer's keys
(``feature_extractor.*``, ``train.checkpoint.save_params``), which
``cli/train_localizer.py --pretrained-model`` restores with the head
skipped. Both layouts have the port's weight shapes: they differ only in
where the downsampling stride sits (torchvision: the 3x3 conv;
caffe/chainer and the port: the first 1x1), which the weights do not
carry. BatchNorm's ``num_batches_tracked`` counters are not written.

``--verify`` restores the file into a ``Localizer(n_layers=50)`` on
``--device`` (default cuda) and exits 1 unless every backbone tensor was
loaded (``restore_params`` skips a key whose name or shape does not match,
so a wrong map would load nothing and still train).

No weights are downloaded: the checkpoint must already be on disk.
"""

from __future__ import annotations

import argparse
from collections.abc import Iterator, Mapping

import numpy as np
import torch

BLOCKS = (3, 4, 6, 3)
PREFIX = "feature_extractor."
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
CHAINER_BN = {"weight": "gamma", "bias": "beta", "running_mean": "avg_mean", "running_var": "avg_var"}


def r50_modules() -> Iterator[tuple[str, str, str, str, str, str]]:
    """Each convolution of R-50 and its BatchNorm, in torchvision's order:
    ``(port conv, port BatchNorm, torchvision conv, torchvision BatchNorm,
    chainer conv, chainer BatchNorm)`` module paths. The port's (and the
    JAX package's) stem is ``Conv_0``/``BatchNorm_0``; a stage's first block
    ``BottleNeckA_0`` has its projection as ``ConvBN_3`` (torchvision's
    ``downsample``, chainer's ``conv4``/``bn4``); block ``b > 0`` is
    ``BottleNeckB_{b-1}``."""
    yield "Conv_0", "BatchNorm_0", "conv1", "bn1", "conv1", "bn1"
    for s, n_blocks in enumerate(BLOCKS):
        for b in range(n_blocks):
            block = f"BottleNeckStage_{s}." + ("BottleNeckA_0" if b == 0 else f"BottleNeckB_{b - 1}")
            layer = f"layer{s + 1}.{b}"
            branch = f"res{s + 2}/" + ("a" if b == 0 else f"b{b}")
            for ci in range(4 if b == 0 else 3):
                tv = (f"{layer}.conv{ci + 1}", f"{layer}.bn{ci + 1}") if ci < 3 else (
                    f"{layer}.downsample.0", f"{layer}.downsample.1")
                yield (f"{block}.ConvBN_{ci}.Conv_0", f"{block}.ConvBN_{ci}.BatchNorm_0", *tv,
                       f"{branch}/conv{ci + 1}", f"{branch}/bn{ci + 1}")


def float32_tensor(value) -> torch.Tensor:
    """A CPU float32 tensor of its own (a numpy array or a tensor)."""
    return torch.tensor(np.asarray(value), dtype=torch.float32)


def convert_torch(state: Mapping) -> dict[str, torch.Tensor]:
    """torchvision ``resnet50`` ``state_dict`` -> the Localizer's backbone
    keys (``fc`` is not read)."""
    out = {}
    for conv, bn, tv_conv, tv_bn, _, _ in r50_modules():
        out[f"{PREFIX}{conv}.weight"] = float32_tensor(state[f"{tv_conv}.weight"])
        for leaf in BN_LEAVES:
            out[f"{PREFIX}{bn}.{leaf}"] = float32_tensor(state[f"{tv_bn}.{leaf}"])
    return out


def convert_chainer(npz: Mapping) -> dict[str, torch.Tensor]:
    """chainer ``ResNet50Layers`` npz (``conv1/W``, ``bn1/gamma``,
    ``res{2..5}/{a,b1,...}/conv{1..4}/W`` ...) -> the Localizer's backbone
    keys, conv1's input channels reversed from BGR to RGB."""
    out = {}
    for conv, bn, _, _, ch_conv, ch_bn in r50_modules():
        w = float32_tensor(npz[f"{ch_conv}/W"])
        out[f"{PREFIX}{conv}.weight"] = w.flip(1) if conv == "Conv_0" else w
        for leaf in BN_LEAVES:
            out[f"{PREFIX}{bn}.{leaf}"] = float32_tensor(npz[f"{ch_bn}/{CHAINER_BN[leaf]}"])
    return out


def verify(path: str, device: str | torch.device) -> tuple[list[str], list[str]]:
    """Restore ``path`` into a fresh ``Localizer(n_layers=50)`` on
    ``device`` (its head skipped): ``(loaded, missing)`` backbone keys,
    BatchNorm counters left out."""
    from loans_tpu_torch.models import Localizer
    from loans_tpu_torch.train import checkpoint

    localizer = Localizer(n_layers=50).to(device)
    loaded = checkpoint.restore_params(path, localizer, skip_prefixes=("param_predictor",))
    backbone = [k for k in localizer.state_dict()
                if k.startswith(PREFIX) and not k.endswith("num_batches_tracked")]
    return [k for k in backbone if k in loaded], sorted(set(backbone) - set(loaded))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert a torchvision or chainer ResNet-50 into the port's "
                                            "--pretrained-model file")
    p.add_argument("checkpoint", help=".pth (torchvision state_dict) or .npz (chainer)")
    p.add_argument("output", help="output .pt (a state_dict under the Localizer's keys)")
    p.add_argument("--source", choices=["torch", "chainer"], default=None,
                   help="checkpoint layout (default: chainer for .npz, else torch)")
    p.add_argument("--verify", action="store_true",
                   help="restore the result into a Localizer and exit 1 unless every backbone tensor loads")
    p.add_argument("--device", default="cuda", help="device of the --verify Localizer (default cuda)")
    return p


def main(argv=None) -> str:
    """Convert, write ``output`` and, with ``--verify``, check it; returns
    ``output``."""
    from loans_tpu_torch.train import checkpoint

    args = get_parser().parse_args(argv)
    source = args.source or ("chainer" if args.checkpoint.endswith(".npz") else "torch")
    if source == "torch":
        state_dict = convert_torch(torch.load(args.checkpoint, map_location="cpu", weights_only=True))
    else:
        with np.load(args.checkpoint) as npz:
            state_dict = convert_chainer(npz)
    checkpoint.save_params(args.output, state_dict)
    n = sum(v.numel() for k, v in state_dict.items() if ".running_" not in k)
    print(f"wrote {args.output} ({n / 1e6:.1f}M params)")
    if args.verify:
        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda but torch.cuda.is_available() is false; pass --device cpu")
        loaded, missing = verify(args.output, args.device)
        print(f"verify: {len(loaded)}/{len(loaded) + len(missing)} backbone tensors imported")
        if missing:
            raise SystemExit(f"verify: {len(missing)} backbone tensors kept their fresh init "
                             f"(name or shape mismatch): {missing[:4]}")
    return args.output


if __name__ == "__main__":
    main()
