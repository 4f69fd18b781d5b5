"""Pretrain a ResNet-50 backbone as a stamp classifier on procedural scenes
(port of ``tools/pretrain_backbone.py``).

    python -m loans_tpu_torch.cli.pretrain_backbone --out /tmp/pre/backbone.pth
    python -m loans_tpu_torch.cli.import_resnet50 /tmp/pre/backbone.pth pre.pt --verify
    python -m loans_tpu_torch.cli.train_localizer ... --n-layers 50 --pretrained-model pre.pt

The reference starts its localizer from an ImageNet R-50
(``sheep/sheep_localizer.py:128``); its ``sheep/resnet.py:60-67`` has a
classifier head for making such weights. This tool makes the same kind of
artifact from the procedural world: it trains ``ResNet(50,
class_labels=K)`` to tell WHICH of K procedural stamps a scene holds
(``make_scene_pool``), then exports the backbone in torchvision's
``resnet50`` layout (``export_torchvision_resnet50``), so that the result
goes through the real import path.

The training is the JAX tool's: uint8 scene pools resident on the device,
``--steps-per-call`` steps a call on batches gathered there
(``data.device_data.device_chunk_batches``, ``train.steps.pooled_step``),
the Localizer's preprocessing (u8 - ImageNet mean, RGB), a horizontal
flip per image, softmax cross-entropy, Adam(amsgrad) with the learning
rate cut tenfold at 75% of the iterations, and the validation accuracy in
eval mode. ``--bf16`` runs the convolutions, BatchNorm outputs and the
head in bfloat16, as the JAX tool's ``--bf16``. ``--image-size`` (default
224, the JAX tool's fixed size) shrinks the scenes for a test.
``--device`` defaults to ``cuda``.

Data-parallel over N GPUs, one process each, as the JAX tool is over a
host's devices::

    torchrun --standalone --nproc_per_node=N -m loans_tpu_torch.cli.pretrain_backbone --out ...

``--batch-size`` is the global batch; it must divide by N. Each process
trains on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the CPU) on its
columns of every batch, with BatchNorm over the global batch, the
gradients averaged over the ranks and the flips drawn for the global
batch; the logged loss and accuracy are global means, each rank scores a
share of the validation pool, and rank 0 prints and writes ``--out``.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from loans_tpu_torch import parallel
from loans_tpu_torch.cli.import_resnet50 import BN_LEAVES, r50_modules
from loans_tpu_torch.data.device_augment import draw_rows
from loans_tpu_torch.models.localizer import IMAGENET_MEAN_RGB
from loans_tpu_torch.train.state import TrainState


# -- torchvision-layout export --------------------------------------------
def export_torchvision_resnet50(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's ``ResNet(50)`` ``state_dict`` (with or without the
    classifier head) -> torchvision ``resnet50`` keys, float32 on the CPU:
    the inverse of ``import_resnet50.convert_torch``. The head
    (``Dense_0``) is dropped, as only the backbone transfers; every
    ``num_batches_tracked`` is 0, as the JAX tool writes it."""
    out = {}

    def put(src: str, dst: str) -> None:
        out[dst] = state_dict[src].detach().to("cpu", torch.float32).clone()

    for conv, bn, tv_conv, tv_bn, _, _ in r50_modules():
        put(f"{conv}.weight", f"{tv_conv}.weight")
        for leaf in BN_LEAVES:
            put(f"{bn}.{leaf}", f"{tv_bn}.{leaf}")
        out[f"{tv_bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


# -- labeled scene pool ----------------------------------------------------
def make_scene_pool(n: int, classes: int, asset_seed: int, seed: int, image_size=(224, 224)) -> dict:
    """``{'images': (n, H, W, 3) uint8, 'labels': (n,) int32}``: each scene
    holds one of ``classes`` procedural stamps, drawn per scene, and is
    labeled by it; the JAX tool's draws and pixels."""
    from loans_tpu_torch.data.synthetic import PasteAndCropGenerator

    gen = PasteAndCropGenerator(image_size=image_size, n_procedural=classes, asset_seed=asset_seed, seed=seed)
    images = np.empty((n, image_size[1], image_size[0], 3), np.uint8)
    labels = np.empty((n,), np.int32)
    for i in range(n):
        cls = gen.rng.randrange(classes)
        images[i] = gen.paste(stamp_index=cls).image[..., :3]
        labels[i] = cls
    return {"images": images, "labels": labels}


# -- the classifier step -----------------------------------------------------
@functools.lru_cache(maxsize=None)
def _mean(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The ImageNet mean on ``device`` in ``dtype``, made once per pair: a
    tensor made from host values on a card is a copy that waits for the
    card's queue to drain."""
    return torch.tensor(IMAGENET_MEAN_RGB, dtype=torch.float64).to(device, dtype)


def preprocess(model: torch.nn.Module, u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> NCHW ``u8 - mean`` in the model's compute dtype
    (the Localizer's x * 255 - mean for x = u8 / 255)."""
    dtype = model.Conv_0.compute_dtype or torch.float32
    return (u8.to(dtype) - _mean(u8.device, dtype)).permute(0, 3, 1, 2)


def draw_flips(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n,) bool: which images of a batch are flipped, each with
    probability 1/2, drawn on ``generator``'s device. In data-parallel
    training the mask is drawn for the global batch and this rank keeps
    its rows (``data.device_augment.draw_rows``), as the JAX tool draws it
    for the whole sharded batch."""
    return draw_rows(generator, n) < 0.5


def classifier_step(state: TrainState, batch: dict[str, torch.Tensor],
                    flip: torch.Tensor) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One classifier update in place: ``batch['images']`` (N, H, W, 3)
    uint8, flipped left-right where ``flip`` (N,) is true, and
    ``batch['labels']`` (N,); softmax cross-entropy on the float32 logits,
    averaged over the batch. Returns ``loss`` and ``acc``."""
    model = state.model.train()
    x = preprocess(model, batch["images"])
    x = torch.where(flip.to(x.device)[:, None, None, None], x.flip(3), x)
    labels = batch["labels"].long()
    state.optimizer.zero_grad(set_to_none=True)
    logits = model(x).float()
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    state.apply_gradients()
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return state, {"loss": loss.detach(), "acc": acc}


def classifier_body(state: TrainState, ass_state: None, batch: dict[str, torch.Tensor],
                    generator: torch.Generator, config=None):
    """``pooled_step``'s body: the flips drawn on ``generator``, then
    ``classifier_step``."""
    del ass_state, config
    state, metrics = classifier_step(state, batch, draw_flips(generator, batch["labels"].shape[0]))
    return state, None, metrics


@torch.inference_mode()
def val_accuracy(model: torch.nn.Module, pool: dict, batch_size: int, device: torch.device) -> float:
    """Eval-mode accuracy over the whole batches of ``pool``. In
    data-parallel training rank r scores batches r, r + W, ... and the
    counts are summed over the ranks: every rank returns the accuracy of
    the whole pool."""
    model.eval()
    n = (len(pool["labels"]) // batch_size) * batch_size
    step = batch_size * parallel.data_parallel_size()
    correct = 0
    for start in range(parallel.data_parallel_rank() * batch_size, n, step):
        images = torch.from_numpy(pool["images"][start:start + batch_size]).to(device)
        pred = model(preprocess(model, images)).float().argmax(-1).cpu().numpy()
        correct += int((pred == pool["labels"][start:start + batch_size]).sum())
    correct = int(parallel.global_sum(torch.tensor(correct, dtype=torch.int64, device=device)))
    return correct / max(n, 1)


# -- the CLI --------------------------------------------------------------
def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Pretrain a ResNet-50 backbone as a stamp classifier and export it "
                                            "in torchvision's layout")
    p.add_argument("--out", required=True, help="output .pth path (torchvision resnet50 state_dict)")
    p.add_argument("--classes", type=int, default=64)
    p.add_argument("--pool", type=int, default=8192)
    p.add_argument("--val-pool", type=int, default=1024)
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--asset-seed", type=int, default=None,
                   help="share a visual world with the main trainer's --synthetic-assets (pass the same value)")
    p.add_argument("--steps-per-call", type=int, default=50)
    p.add_argument("--log-interval", type=int, default=500)
    p.add_argument("--pool-refresh", type=int, default=0,
                   help="regenerate the train pool every N chunks (0 = fixed pool)")
    p.add_argument("--image-size", type=int, default=224, help="scene side (the JAX tool's 224)")
    p.add_argument("--device", default="cuda", help="torch device to train on (default cuda)")
    return p


def main(argv=None) -> dict:
    """Pretrain, export and write ``--out`` (under ``torchrun``: rank 0
    writes). Returns ``{'out', 'log' (one dict per log entry: iteration,
    loss, acc, images_per_sec), 'acc' (the last call's), 'val_acc',
    'tensors'}``; under ``torchrun`` the losses and accuracies are the
    global batch's on every rank."""
    from loans_tpu_torch.cli.train_localizer import start_devices

    args = get_parser().parse_args(argv)
    with parallel.process_group(torch.device(args.device).type):
        return pretrain(args, start_devices(args))


def pretrain(args, device: torch.device) -> dict:
    """The run of ``main`` on ``device``."""
    from loans_tpu_torch.data.device_data import device_chunk_batches
    from loans_tpu_torch.inference.localizer import set_precision
    from loans_tpu_torch.models.resnet import ResNet, set_dtypes
    from loans_tpu_torch.train import create_train_state, pooled_step

    set_precision()
    main_rank = parallel.is_main()
    asset_seed = args.asset_seed if args.asset_seed is not None else args.seed
    size = (args.image_size, args.image_size)
    t0 = time.time()
    if main_rank:
        print(f"generating {args.pool}+{args.val_pool} labeled scenes ({args.classes} classes)...", flush=True)
    train_pool = make_scene_pool(args.pool, args.classes, asset_seed, args.seed, size)
    val_pool = make_scene_pool(args.val_pool, args.classes, asset_seed, args.seed + 1, size)
    if main_rank:
        print(f"pools ready in {time.time() - t0:.0f}s", flush=True)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    torch.manual_seed(args.seed)
    model = set_dtypes(ResNet(50, class_labels=args.classes), dtype, dtype).to(device)
    parallel.replicate(model)
    state = create_train_state(model, args.lr)

    refresh = None
    if args.pool_refresh:
        def factory(generation: int) -> dict:
            return make_scene_pool(args.pool, args.classes, asset_seed, args.seed + 100 + generation, size)
        refresh = {"cls": (factory, args.pool_refresh)}
    chunks = device_chunk_batches({"cls": train_pool}, args.batch_size, args.steps_per_call, seed=args.seed,
                                  device=device, refresh=refresh)
    generator = torch.Generator(device=device).manual_seed(args.seed + 7)
    log, metrics = [], {"acc": torch.tensor(float("nan"), device=device)}
    done, decayed = 0, False
    t0 = time.time()
    try:
        while done < args.iterations:
            if not decayed and done >= int(args.iterations * 0.75):
                state.with_learning_rate(args.lr * 0.1)
                decayed = True
            state, _, metrics = pooled_step(state, None, next(chunks), generator, args.steps_per_call,
                                            body=classifier_body)
            done += args.steps_per_call
            if done % args.log_interval < args.steps_per_call:
                entry = {"iteration": done, **parallel.reduce_metrics([metrics])[0]}
                entry["images_per_sec"] = done * args.batch_size / (time.time() - t0)
                log.append(entry)
                if main_rank:
                    print(f"iter={done}  loss={entry['loss']:.4f}  acc={entry['acc']:.4f}  "
                          f"images_per_sec={entry['images_per_sec']:.1f}", flush=True)
    finally:
        chunks.close()  # waits for a running pool refresh

    vacc = val_accuracy(model, val_pool, args.batch_size, device)
    acc = parallel.reduce_metrics([{"acc": metrics["acc"]}])[0]["acc"]
    state_dict = export_torchvision_resnet50(model.state_dict())
    if main_rank:
        print(f"final train acc={acc:.4f}  val acc={vacc:.4f}")
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save(state_dict, args.out)
        print(f"wrote {args.out} ({len(state_dict)} tensors, val_acc={vacc:.4f})")
    return {"out": args.out, "log": log, "acc": acc, "val_acc": vacc, "tensors": len(state_dict)}


if __name__ == "__main__":
    main()
