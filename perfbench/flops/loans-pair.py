"""Operations of a LoANs localizer/assessor pair (``loans-r50``), counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's own
reference on the meta device at the cell's shapes (convolutions and
matrix products, each multiply-add two operations, as direct convolution
does them; elementwise work is not counted).

``train_step``: one alternating step, that is the localizer forward and
backward, the assessor on the crops forward and back to its input, and the
assessor on the labelled crops forward and backward.
``serve_batch``: the localizer's and the assessor's forward on a batch.
The crop is not counted: a stand-in of the crops' shape, differentiable in
theta, takes its place (the crop's bilinear taps are a few thousandths of
the step's work, and the reference's tap matrices would count as products
that no crop needs).
"""

from __future__ import annotations

import torch
from torch.func import functional_call
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import loans_pair as ref


def _stand_in(scenes, theta, out):
    return scenes[:, : out[0], : out[1], :] * theta[:, 0, 0, None, None, None]


def count(workload: dict, config: dict) -> dict[str, float]:
    t, lc = workload["traffic"], config["localizer"]
    n = t["batch"]
    size, out = tuple(lc["input_size"]), tuple(lc["out_size"])
    loc, ass = ref.build(config, "meta")
    scenes = torch.empty(n, *size, 3, device="meta")
    real = torch.empty(n, *out, 3, device="meta")
    counter = FlopCounterMode(display=False)
    if workload["driver"] == "train_pooled":
        with counter:
            theta = loc.theta(scenes)
            rois = _stand_in(scenes, theta, out)
            y_fake = functional_call(ass, {k: v.detach() for k, v in ass.named_parameters()}, (rois,))
            loss = torch.mean(torch.square(y_fake - 1.0)) + ref.regularisers(theta, size)
            torch.autograd.grad(loss, list(loc.parameters()))
            loss_dis = torch.mean(torch.square(ass(real) - 0.5))
            torch.autograd.grad(loss_dis, list(ass.parameters()))
        return {"train_step": float(counter.get_total_flops())}
    loc.eval()
    with counter, torch.no_grad():
        theta = loc.theta(scenes)
        ass(_stand_in(scenes, theta, out))
    return {"serve_batch": float(counter.get_total_flops())}
