"""Whole served batch's share of the card's float32 peak: the operations
of the forward passes of a batch (``flops/<family>.py``) times the batches
of the measured window, over the window's seconds and 67 TFLOP/s."""

from perfbench.yardstick import FP32_FLOPS_PER_S


def read(ctx):
    if ctx.device.type != "cuda" or "serve_batch" not in ctx.flops:
        return None
    return 100.0 * ctx.flops["serve_batch"] * ctx.window["batches"] / ctx.window["seconds"] / FP32_FLOPS_PER_S
