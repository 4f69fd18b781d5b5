"""Whole training step's share of the card's float32 peak: the operations
a step needs (``flops/<family>.py``) times the steps of the measured
window, over the window's seconds and 67 TFLOP/s."""

from perfbench.yardstick import FP32_FLOPS_PER_S


def read(ctx):
    if ctx.device.type != "cuda" or "train_step" not in ctx.flops:
        return None
    return 100.0 * ctx.flops["train_step"] * ctx.window["steps"] / ctx.window["seconds"] / FP32_FLOPS_PER_S
