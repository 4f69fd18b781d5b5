"""The plain reference against ``loans_tpu_torch`` at a tiny size on the
CPU: the crop and its d theta, the served forward, and one alternating
step's losses and gradients. (The test may import the program; the
reference may not.)"""

from __future__ import annotations

import torch

from perfbench import harness
from perfbench.reference import loans_pair as ref

ADAPTER = harness.load_module("adapters", "loans-pair")


def test_crop_and_its_theta_gradient_match_the_programs():
    from loans_tpu_torch.ops.stn import sample_separable

    gen = torch.Generator().manual_seed(1)
    images = torch.rand(3, 20, 24, 2, generator=gen)
    theta = torch.zeros(3, 2, 3)
    theta[:, 0, 0], theta[:, 1, 1] = 0.5 + torch.rand(3, generator=gen), 0.5 + torch.rand(3, generator=gen)
    theta[:, :, 2] = torch.rand(3, 2, generator=gen) - 0.5
    g = torch.rand(3, 7, 9, 2, generator=gen)
    a, b = theta.clone().requires_grad_(), theta.clone().requires_grad_()
    mine, theirs = ref.crop(images, a, (7, 9)), sample_separable(images, b, (7, 9))
    assert torch.allclose(mine, theirs, atol=1e-5)
    (da,), (db,) = torch.autograd.grad(mine, a, g), torch.autograd.grad(theirs, b, g)
    # the separable crop reads theta's diagonal and shifts only; the localizer zeroes the rest
    used = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]).bool()
    assert torch.allclose(da[:, used], db[:, used], rtol=1e-4, atol=1e-4)


def test_served_forward_matches_the_programs(tiny_config, tiny_cells):
    from loans_tpu_torch.ops.geometry import Size, corners_to_aabb, theta_corners

    ctx = harness.Context(tiny_cells["serve"], tiny_config, 5, torch.device("cpu"))
    loc, ass = ADAPTER.program_models(ctx, ADAPTER.weights(ctx, calibrated=True))
    loc.eval()
    ass.eval()
    frames = ADAPTER.frame_pool(ctx)[:6]
    with torch.no_grad():
        rois, theta = loc(frames)
        boxes = corners_to_aabb(theta_corners(theta), Size(32, 32), clip=True)
        scores = ass(rois)[:, 0]
    truth = ref.serve(tiny_config, ADAPTER.weights(ctx, calibrated=True), frames)
    assert torch.allclose(boxes, truth["boxes"], atol=1e-4)
    assert torch.allclose(rois, truth["rois"], atol=1e-5)
    assert torch.allclose(scores, truth["scores"], atol=1e-6)
    assert not torch.allclose(theta[0], theta[1])  # the head's weights make theta depend on the frame


def test_one_alternating_step_matches_the_programs(tiny_config, tiny_cells):
    from loans_tpu_torch.ops.geometry import Size
    from loans_tpu_torch.train import AlternatingConfig, create_train_state
    from loans_tpu_torch.train.steps import alternating_step

    ctx = harness.Context(tiny_cells["train"], tiny_config, 9, torch.device("cpu"))
    w = ADAPTER.weights(ctx)
    loc, ass = ADAPTER.program_models(ctx, w)
    scenes, crops, labels = ADAPTER.pools(ctx)
    batch = {"unlabeled": scenes[:4], "real": crops[:4], "labels": labels[:4]}
    ls, as_ = create_train_state(loc), create_train_state(ass)
    _, _, metrics = alternating_step(ls, as_, batch, None, AlternatingConfig(image_size=Size(32, 32)))
    truth = ref.train_steps(tiny_config, w, [(scenes[:4], crops[:4], labels[:4])])
    assert abs(float(metrics["loss_localizer"]) - truth["losses"][0][0]) <= 1e-5 * truth["losses"][0][0]
    assert abs(float(metrics["loss_dis"]) - truth["losses"][0][1]) <= 1e-5 * truth["losses"][0][1]
    for prefix, state in (("localizer.", ls), ("assessor.", as_)):
        for name, p in state.model.named_parameters():
            g = state.optimizer.state[p]["mu"] / 0.1
            assert abs(float(g.norm()) - truth["grad1"][prefix + name]) <= 1e-4 * truth["grad1"][prefix + name] + 1e-9
            for moment in ("mu", "nu_max"):
                mine = float(state.optimizer.state[p][moment].norm())
                theirs = truth["moments"][0][moment][prefix + name]
                assert abs(mine - theirs) <= 2e-4 * theirs + 1e-12, (prefix + name, moment)
