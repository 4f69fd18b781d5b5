"""The ``ssd300`` configuration in the program and in its reference:
SSD300 over VGG16 with one foreground class, float32 with TF32 off, from
weights drawn from the seed, trained through ``train.steps.pooled_step``
over ``data.ssd_device.SSDPooledBody`` (augmentation on the card, the
window rendered by the crop at C = 4, ``encode_batch``, the multibox loss,
``SSDAdam``), as the SSD training CLI runs it."""

from __future__ import annotations

import functools

import torch

from perfbench import compare, inputs
from perfbench.probe import Probe
from perfbench.reference import ssd as ref


def weights(ctx) -> dict[str, torch.Tensor]:
    if "weights" not in ctx.memo:
        w = inputs.seeded_weights(ref.weight_spec(ctx.config), ctx.seed, "weights", ctx.device)
        ctx.memo["weights"] = {k: v.cpu() for k, v in w.items()}
    return {k: v.to(ctx.device) for k, v in ctx.memo["weights"].items()}


def pools(ctx):
    """uint8 scenes, each with one box whose sides are drawn as the
    synthetic world draws a stamp's (uniform over [S/15, S/2] pixels) at a
    uniform position: (scenes, boxes (N, 1, 4) pixel yxyx, valid (N, 1))."""
    n, s = ctx.traffic["pool_scenes"], ctx.config["input_size"]
    scenes = inputs.uint8_pool(ctx.seed, "scenes", (n, s, s, 3), ctx.device)
    u = inputs.uniform_pool(ctx.seed, "boxes", (n, 4), ctx.device)
    lo, hi = s // 15, s // 2
    side = torch.floor(lo + u[:, :2] * (hi - lo + 1))  # (h, w)
    corner = torch.floor(u[:, 2:] * (s - side + 1))  # (y0, x0)
    boxes = torch.cat([corner, corner + side], 1)[:, None, :]
    return scenes, boxes, torch.ones(n, 1, dtype=torch.bool, device=ctx.device)


class TrainProgram:
    loss_key = "loss"

    def __init__(self, ctx):
        from loans_tpu_torch.data.device_data import device_chunk_batches
        from loans_tpu_torch.data.ssd_device import SSDPooledBody
        from loans_tpu_torch.inference.localizer import set_precision
        from loans_tpu_torch.models import SSD300
        from loans_tpu_torch.train import pooled_step
        from loans_tpu_torch.train.ssd_steps import create_ssd_train_state

        t, c = ctx.traffic, ctx.config
        if t["warmup_calls"] * t["steps_per_call"] < t["checked_steps"]:
            raise ValueError("the warm-up calls do not reach the checked steps")
        set_precision()
        with torch.device(ctx.device):
            model = SSD300(n_fg_class=c["n_fg_class"])
        model.load_state_dict(weights(ctx))
        ctx.mark("model built")
        self.state = create_ssd_train_state(model)
        ctx.mark("optimiser made")
        scenes, boxes, valid = pools(ctx)
        pool = {"scenes": scenes.cpu().numpy(), "boxes": boxes.cpu().numpy(), "valid": valid.cpu().numpy()}
        del scenes, boxes, valid
        ctx.mark("pools made and copied to the host")
        self.chunks = device_chunk_batches({"train": pool}, t["batch"], t["steps_per_call"],
                                           seed=inputs.index_seed(ctx.seed), device=ctx.device)
        self.generator = inputs.generator(ctx.seed, "step", ctx.device)
        body = SSDPooledBody(model.coder(), c["input_size"], augment=True)
        self.probe = Probe({"": self.state}, body, t["checked_steps"], ("loss/loc", "loss/conf"))
        self.step = functools.partial(pooled_step, steps_per_call=t["steps_per_call"], body=self.probe)
        self.steps_per_call = t["steps_per_call"]
        self.images_per_call = t["batch"] * t["steps_per_call"]

    def call(self) -> dict:
        self.state, _, metrics = self.step(self.state, None, next(self.chunks), self.generator)
        return metrics

    def readings(self) -> dict:
        return self.probe.readings()

    def close(self) -> None:
        self.chunks.close()
        self.state = self.probe = self.step = self.chunks = None


def train_program(ctx) -> TrainProgram:
    return TrainProgram(ctx)


def train_reference(ctx, *, tf32: bool = False, half: bool = False, columns_first: bool = False) -> dict:
    """The reference's readings over the checked steps, from the same
    weights, pools, rows and augmentation draws as the program's first
    steps."""
    from perfbench.reference.loans_pair import precision

    t = ctx.traffic
    scenes, boxes, valid = pools(ctx)
    rows = inputs.first_epoch_batches(t["pool_scenes"], t["batch"], inputs.index_seed(ctx.seed), t["checked_steps"])
    batches = []
    for r in rows:
        i = torch.as_tensor(r, device=ctx.device)
        batches.append((scenes[i], boxes[i], valid[i]))
    del scenes, boxes, valid
    with precision(tf32):
        return ref.train_steps(ctx.config, weights(ctx), batches, inputs.generator(ctx.seed, "step", ctx.device),
                               half=half, columns_first=columns_first)


def train_check(ctx, readings: dict) -> dict[str, float]:
    return compare.train(readings, train_reference(ctx))


def train_controls(ctx) -> dict[str, dict[str, float]]:
    """The control (the reference in TF32), the fault of half of each batch
    planted in the reference, and a second sound float32 witness (the
    window's crop contracted in the other order)."""
    truth = train_reference(ctx)
    return {"tf32": compare.train(train_reference(ctx, tf32=True), truth),
            "half_batch": compare.train(train_reference(ctx, half=True), truth),
            "witness": compare.train(train_reference(ctx, columns_first=True), truth)}
