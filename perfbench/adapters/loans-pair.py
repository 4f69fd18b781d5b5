"""A LoANs pair configuration (``loans-r50``) in the program and in its
reference: the ResNet-50 Localizer (224² -> 75² on the crop the card
picks) and the ResnetAssessor, float32 with TF32 off, from weights drawn
from the seed.

Training: the alternating step through ``train.steps.pooled_step`` over
the uint8 pools of ``data.device_data.device_chunk_batches``, as the
training CLI runs it. Serving: ``inference.localizer.LocalizerInference``
over a log dir (manifest and snapshots) written from the seeded weights.
"""

from __future__ import annotations

import functools
import os
import shutil
import tempfile

import numpy as np
import torch

from perfbench import compare, inputs
from perfbench.probe import Probe
from perfbench.reference import loans_pair as ref


CALIBRATION_FRAMES = 32


def weights(ctx, calibrated: bool = False) -> dict[str, torch.Tensor]:
    """The pair's weights from the seed, made once a run and kept on the
    host for the reference. ``calibrated`` (serving): with BatchNorm
    statistics calibrated on a batch of frames drawn like the served ones;
    training normalises by each batch's own statistics and needs none."""
    if "weights" not in ctx.memo:
        w = inputs.seeded_weights(ref.weight_spec(ctx.config), ctx.seed, "weights", ctx.device)
        ctx.memo["weights"] = {k: v.cpu() for k, v in w.items()}
    if calibrated and "calibrated" not in ctx.memo:
        lc = ctx.config["localizer"]
        frames = inputs.uniform_pool(ctx.seed, "calibration", (CALIBRATION_FRAMES, *lc["input_size"], 3), ctx.device)
        w = {k: v.to(ctx.device) for k, v in ctx.memo["weights"].items()}
        with ref.precision(False):
            w = ref.calibrate(ctx.config, w, frames)
        ctx.memo["calibrated"] = {k: v.cpu() for k, v in w.items()}
    return {k: v.to(ctx.device) for k, v in ctx.memo["calibrated" if calibrated else "weights"].items()}


def program_state_dict(w: dict, prefix: str) -> dict[str, torch.Tensor]:
    """The program's state dict of one model: the seeded weights and a
    zero ``num_batches_tracked`` beside each BatchNorm."""
    sd = ref.strict_part(w, prefix)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def program_models(ctx, w):
    from loans_tpu_torch.models import Localizer, ResnetAssessor
    from loans_tpu_torch.ops.geometry import Size

    lc = ctx.config["localizer"]
    with torch.device(ctx.device):
        loc = Localizer(out_size=Size(*lc["out_size"]), n_layers=lc["n_layers"],
                        input_size=Size(*lc["input_size"]),
                        rotation_dropout_ratio=lc["rotation_dropout_ratio"], sampler=lc["sampler"])
        ass = ResnetAssessor(ch=ctx.config["assessor"]["ch"], in_size=Size(*lc["out_size"]))
    loc.load_state_dict(program_state_dict(w, "localizer."))
    ass.load_state_dict(program_state_dict(w, "assessor."))
    return loc, ass


def pools(ctx):
    """The training pools on the card: uint8 scenes, uint8 crops and their
    uniform IoU labels."""
    t, lc = ctx.traffic, ctx.config["localizer"]
    scenes = inputs.uint8_pool(ctx.seed, "scenes", (t["pool_scenes"], *lc["input_size"], 3), ctx.device)
    crops = inputs.uint8_pool(ctx.seed, "crops", (t["pool_crops"], *lc["out_size"], 3), ctx.device)
    labels = inputs.uniform_pool(ctx.seed, "labels", (t["pool_crops"], 1), ctx.device)
    return scenes, crops, labels


# -- training -----------------------------------------------------------------
class TrainProgram:
    loss_key = "loss_localizer"

    def __init__(self, ctx):
        from loans_tpu_torch.data.device_data import device_chunk_batches
        from loans_tpu_torch.inference.localizer import set_precision
        from loans_tpu_torch.ops.geometry import Size
        from loans_tpu_torch.train import AlternatingConfig, create_train_state, pooled_step
        from loans_tpu_torch.train.steps import alternating_step

        t = ctx.traffic
        if t["warmup_calls"] * t["steps_per_call"] < t["checked_steps"]:
            raise ValueError("the warm-up calls do not reach the checked steps")
        set_precision()
        loc, ass = program_models(ctx, weights(ctx))
        ctx.mark("models built")
        self.localizer = loc
        self.loc_state, self.ass_state = create_train_state(loc), create_train_state(ass)
        ctx.mark("optimisers made")
        scenes, crops, labels = pools(ctx)
        groups = {"unlabeled": {"unlabeled": scenes.cpu().numpy()},
                  "reference": {"real": crops.cpu().numpy(), "labels": labels.cpu().numpy()}}
        del scenes, crops, labels
        ctx.mark("pools made and copied to the host")
        self.chunks = device_chunk_batches(groups, t["batch"], t["steps_per_call"],
                                           seed=inputs.index_seed(ctx.seed), device=ctx.device)
        self.generator = inputs.generator(ctx.seed, "step", ctx.device)
        self.probe = Probe({"localizer.": self.loc_state, "assessor.": self.ass_state}, alternating_step,
                           t["checked_steps"], ("loss_localizer", "loss_dis"), moments=("mu", "nu_max"))
        self.step = functools.partial(
            pooled_step, steps_per_call=t["steps_per_call"],
            config=AlternatingConfig(image_size=Size(*ctx.config["localizer"]["input_size"])), body=self.probe)
        self.steps_per_call = t["steps_per_call"]
        self.images_per_call = t["batch"] * t["steps_per_call"]

    def call(self) -> dict:
        self.loc_state, self.ass_state, metrics = self.step(
            self.loc_state, self.ass_state, next(self.chunks), self.generator)
        return metrics

    def readings(self) -> dict:
        return self.probe.readings()

    def close(self) -> None:
        self.chunks.close()
        self.loc_state = self.ass_state = self.localizer = self.probe = self.step = self.chunks = None


def train_program(ctx) -> TrainProgram:
    return TrainProgram(ctx)


def train_reference(ctx, *, tf32: bool = False, half: bool = False, columns_first: bool = False) -> dict:
    """The reference's readings over the checked steps, from the same
    weights, pools and rows as the program's first steps."""
    t = ctx.traffic
    w = weights(ctx)
    scenes, crops, labels = pools(ctx)
    s = inputs.index_seed(ctx.seed)  # the feed seeds its groups in order: scenes, then crops
    rows_s = inputs.first_epoch_batches(t["pool_scenes"], t["batch"], s, t["checked_steps"])
    rows_c = inputs.first_epoch_batches(t["pool_crops"], t["batch"], s + 1, t["checked_steps"])
    batches = []
    for a, b in zip(rows_s, rows_c):
        ia, ib = torch.as_tensor(a, device=ctx.device), torch.as_tensor(b, device=ctx.device)
        batches.append((scenes[ia], crops[ib], labels[ib]))
    del scenes, crops, labels
    with ref.precision(tf32):
        return ref.train_steps(ctx.config, w, batches, half=half, columns_first=columns_first)


def train_check(ctx, readings: dict) -> dict[str, float]:
    return compare.train(readings, train_reference(ctx))


def train_controls(ctx) -> dict[str, dict[str, float]]:
    """The numbers that the control (the reference in TF32), the fault
    planted in the reference (half of each batch) and a second sound
    float32 witness (the crop contracted in the other order) read."""
    truth = train_reference(ctx)
    return {"tf32": compare.train(train_reference(ctx, tf32=True), truth),
            "half_batch": compare.train(train_reference(ctx, half=True), truth),
            "witness": compare.train(train_reference(ctx, columns_first=True), truth)}


# -- serving ------------------------------------------------------------------
def manifest(config: dict) -> dict:
    lc = config["localizer"]
    return {
        "localizer": {"model": "Localizer", "kwargs": {
            "out_size": list(lc["out_size"]), "n_layers": lc["n_layers"], "input_size": list(lc["input_size"]),
            "rotation_dropout_ratio": lc["rotation_dropout_ratio"], "sampler": lc["sampler"],
            "transform_rois_to_grayscale": False}},
        "assessor": {"model": "ResnetAssessor", "kwargs": {"ch": config["assessor"]["ch"]}},
        "snapshot_names": ["Localizer", "ResnetAssessor"],
    }


def frame_pool(ctx) -> torch.Tensor:
    """Preprocessed float32 NHWC frames in [0, 1) on the card."""
    t, lc = ctx.traffic, ctx.config["localizer"]
    return inputs.uniform_pool(ctx.seed, "frames", (t["pool_frames"], *lc["input_size"], 3), ctx.device)


def frame_rows(ctx, index: int) -> slice:
    b, p = ctx.traffic["batch"], ctx.traffic["pool_frames"]
    start = (index * b) % p
    return slice(start, start + b)


class ServeProgram:
    def __init__(self, ctx):
        from loans_tpu_torch.inference.localizer import LocalizerInference
        from loans_tpu_torch.train import checkpoint

        t = ctx.traffic
        if t["pool_frames"] % t["batch"]:
            raise ValueError("the frame pool is not a whole number of batches")
        self.ctx = ctx
        w = weights(ctx, calibrated=True)
        log_dir = tempfile.mkdtemp(prefix="perfbench-serve-")
        try:
            checkpoint.save_manifest(log_dir, manifest(ctx.config))
            checkpoint.save_params(os.path.join(log_dir, "Localizer_1.pt"), program_state_dict(w, "localizer."))
            checkpoint.save_params(os.path.join(log_dir, "ResnetAssessor_1.pt"), program_state_dict(w, "assessor."))
            del w
            self.inference = LocalizerInference(log_dir, device=ctx.device, score_threshold=t["score_threshold"],
                                                use_assessor=True)
        finally:
            shutil.rmtree(log_dir)
        self.localizer = self.inference.localizer
        self.frames = frame_pool(ctx).cpu().numpy()

    def serve(self, index: int) -> dict[str, np.ndarray]:
        boxes, rois, scores, _ = self.inference.localize_batch(self.frames[frame_rows(self.ctx, index)], sync=True)
        return {"boxes": boxes.reshape(len(boxes), 4), "rois": rois, "scores": scores}

    def close(self) -> None:
        self.inference = self.localizer = self.frames = None


def serve_program(ctx) -> ServeProgram:
    return ServeProgram(ctx)


def serve_reference(ctx, indices, *, tf32: bool = False) -> dict[str, np.ndarray]:
    """The reference's ungated outputs for the frames of the batches
    ``indices``."""
    frames = frame_pool(ctx)
    picked = torch.cat([frames[frame_rows(ctx, i)] for i in indices])
    del frames
    with ref.precision(tf32):
        out = ref.serve(ctx.config, weights(ctx, calibrated=True), picked)
    return {k: v.cpu().numpy() for k, v in out.items()}


def gated(out: dict[str, np.ndarray], threshold: float) -> dict[str, np.ndarray]:
    shut = out["scores"] < threshold
    return {"boxes": np.where(shut[:, None], 0.0, out["boxes"]).astype(out["boxes"].dtype),
            "rois": out["rois"], "scores": np.where(shut, 0.0, out["scores"]).astype(out["scores"].dtype)}


def serve_check(ctx, outputs: dict) -> dict[str, float]:
    t = ctx.traffic
    truth = serve_reference(ctx, outputs["indices"])
    return compare.serve(outputs, truth, t["score_threshold"], t["gate_margin"])


def serve_controls(ctx, indices) -> dict[str, dict[str, float]]:
    t = ctx.traffic
    truth = serve_reference(ctx, indices)
    control = gated(serve_reference(ctx, indices, tf32=True), t["score_threshold"])
    return {"tf32": compare.serve(control, truth, t["score_threshold"], t["gate_margin"])}
