"""Operations of an SSD300 training step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's own
reference on the meta device at the cell's batch: the forward and the
backward of the network (convolutions; the augmentation's crop, the
encoding and the loss's elementwise work are not counted)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import ssd as ref


def count(workload: dict, config: dict) -> dict[str, float]:
    n, s = workload["traffic"]["batch"], config["input_size"]
    with torch.device("meta"):
        model = ref.SSD300(config["n_fg_class"])
    images = torch.empty(n, s, s, 3, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        mb_loc, mb_conf = model(images)
        torch.autograd.grad(mb_loc.sum() + mb_conf.sum(), list(model.parameters()))
    return {"train_step": float(counter.get_total_flops())}
