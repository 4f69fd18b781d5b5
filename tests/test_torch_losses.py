"""Losses of the PyTorch port against the JAX package: values and gradients.

Inputs are those of ``tests/test_losses.py`` (hand-built theta whose
corners sit inside, outside and, at the identity, exactly on the image
border), plus a random batch. Gradients are taken w.r.t. theta (or the
boxes and logits) with ``jax.grad`` and torch autograd. At the border
ties (a corner exactly at -1 or 1) JAX's ``maximum``/``minimum`` pass half
the gradient and ``abs'(0) = +1``; the port follows, so gradients are
compared there too.

Tolerance: 1e-5 relative to the largest magnitude of the compared value
(float32 on both sides, the same formulas).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from loans_tpu.ops import geometry as jgeo
from loans_tpu.ops import losses as jlosses
from loans_tpu_torch.ops import geometry as tgeo
from loans_tpu_torch.ops import losses as tlosses

RTOL = 1e-5
SIZE = (100, 100)
OUT = (25, 25)


def make_theta(sx, sy, tx=0.0, ty=0.0, r=0.0):
    return [[sx, r, tx], [-r, sy, ty]]


THETAS = {
    "upright": [make_theta(0.8, 0.8), make_theta(0.9, 0.9)],
    "flipped": [make_theta(0.8, -0.8), make_theta(-0.5, 0.7)],
    "outside": [make_theta(1.0, 0.5, tx=-0.5), make_theta(1.0, 0.5, tx=-0.5)],
    "identity_ties": [make_theta(1.0, 1.0), make_theta(1.0, 1.0)],  # corners at +-1
    "areas": [make_theta(1.0, 1.0), make_theta(0.1, 0.1), make_theta(3.0, 3.0)],
    "aspect": [make_theta(0.8, 0.2), make_theta(0.2, 0.8)],
    "random": np.random.default_rng(0).uniform(-1.2, 1.2, (6, 2, 3)).tolist(),
}

LOSSES = {
    "direction": (lambda c, s: jlosses.direction_loss(c, jgeo.Size(*s)),
                  lambda c, s: tlosses.direction_loss(c, tgeo.Size(*s))),
    "out_of_image": (lambda c, s: jlosses.out_of_image_loss(c),
                     lambda c, s: tlosses.out_of_image_loss(c)),
    "min_area": (lambda c, s: jlosses.min_area_loss(c, jgeo.Size(*s), jgeo.Size(*OUT)),
                 lambda c, s: tlosses.min_area_loss(c, tgeo.Size(*s), tgeo.Size(*OUT))),
    "max_area": (lambda c, s: jlosses.max_area_loss(c, jgeo.Size(*s)),
                 lambda c, s: tlosses.max_area_loss(c, tgeo.Size(*s))),
    "aspect_ratio": (lambda c, s: jlosses.aspect_ratio_loss(c, jgeo.Size(*s)),
                     lambda c, s: tlosses.aspect_ratio_loss(c, tgeo.Size(*s))),
}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _both(jax_fn, torch_fn, *arrays):
    """Value and gradients w.r.t. every input, from both frameworks."""
    j_args = [jnp.asarray(a) for a in arrays]
    want, j_grads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(*j_args)
    t_args = [torch.tensor(np.asarray(a), requires_grad=True) for a in arrays]
    got = torch_fn(*t_args)
    got.backward()
    return (float(got.detach()), [a.grad.numpy() for a in t_args]), (float(want), [np.asarray(g) for g in j_grads])


@pytest.mark.parametrize("theta_name", sorted(THETAS))
@pytest.mark.parametrize("loss_name", sorted(LOSSES))
def test_corner_loss_and_gradient_match_jax(loss_name, theta_name):
    jax_loss, torch_loss = LOSSES[loss_name]
    theta = np.asarray(THETAS[theta_name], np.float32)
    (got, got_g), (want, want_g) = _both(
        lambda t: jax_loss(jgeo.theta_corners(t), SIZE),
        lambda t: torch_loss(tgeo.theta_corners(t), SIZE),
        theta,
    )
    _close(got, want)
    _close(got_g[0], want_g[0])


def test_reference_values():
    """The hand-computed values of ``tests/test_losses.py``."""
    def corners(*t):
        return tgeo.theta_corners(torch.tensor([make_theta(*t)], dtype=torch.float32))

    size = tgeo.Size(*SIZE)
    assert float(tlosses.direction_loss(corners(0.8, 0.8), size)) == 0.0
    np.testing.assert_allclose(float(tlosses.direction_loss(corners(0.8, -0.8), size)), 80.0, atol=1e-4)
    assert float(tlosses.out_of_image_loss(corners(0.9, 0.9))) == 0.0
    np.testing.assert_allclose(float(tlosses.out_of_image_loss(corners(1.0, 0.5, -0.5))), 0.5, atol=1e-5)
    three = tgeo.theta_corners(torch.tensor([make_theta(1.0, 0.5, -0.5)] * 3))
    np.testing.assert_allclose(float(tlosses.out_of_image_loss(three)), 1.5, atol=1e-5)  # a sum
    out = tgeo.Size(*OUT)
    np.testing.assert_allclose(float(tlosses.min_area_loss(corners(0.1, 0.1), size, out)), 30.0, atol=1e-3)
    np.testing.assert_allclose(float(tlosses.max_area_loss(corners(3.0, 3.0), size)), 400.0, atol=1e-3)
    np.testing.assert_allclose(float(tlosses.aspect_ratio_loss(corners(0.2, 0.8), size)), 3.5, atol=1e-4)


def test_tie_gradients_follow_jax_not_torch_defaults():
    """At the identity, out-of-image's terms sit exactly on their ties:
    JAX gives each tracked coordinate +0.5 (low side: abs'(0) = +1 times
    the minimum's half) or +0.5 (high side: the maximum's half). torch's
    relu/abs defaults would give 0 there."""
    theta = torch.tensor([make_theta(1.0, 1.0)], requires_grad=True)
    tlosses.out_of_image_loss(tgeo.theta_corners(theta)).backward()
    want = jax.grad(lambda t: jlosses.out_of_image_loss(jgeo.theta_corners(t)))(
        jnp.asarray([make_theta(1.0, 1.0)], jnp.float32))
    np.testing.assert_array_equal(theta.grad.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).max() > 0


def _boxes(rng, n):
    lo = rng.uniform(0, 50, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(1, 40, (n, 2))], axis=1).astype(np.float32)


def test_huber_and_iou_losses_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (5, 4)).astype(np.float32)
    t = rng.normal(0, 2, (5, 4)).astype(np.float32)
    (got, got_g), (want, want_g) = _both(
        lambda a, b: jnp.sum(jlosses.huber_loss(a, b)),
        lambda a, b: tlosses.huber_loss(a, b).sum(), x, t)
    _close(got, want)
    for a, b in zip(got_g, want_g):
        _close(a, b)
    pred, gt = _boxes(rng, 6), _boxes(rng, 6)
    gt[0] = pred[0]  # a perfect match: intersection extents equal, ties
    for jfn, tfn in ((jlosses.iou_loss, tlosses.iou_loss),
                     (jlosses.smooth_iou_loss, tlosses.smooth_iou_loss)):
        (got, got_g), (want, want_g) = _both(jfn, tfn, pred, gt)
        _close(got, want)
        for a, b in zip(got_g, want_g):
            _close(a, b)


def test_transform_param_regression_loss_matches_jax():
    rng = np.random.default_rng(0)
    n = 6
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.0, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.0, n)
    gt = np.array([[-0.5, -0.5, 0.5, 0.5], [-0.2, -0.2, 0.9, 0.9], [0, 0, 0, 0]], np.float32)
    mask = np.array([True, True, False])
    scores = rng.normal(size=(n, 2)).astype(np.float32)

    def jfn(t, s):
        reg, obj = jlosses.transform_param_regression_loss(
            jgeo.theta_corners(t), jnp.asarray(gt), jnp.asarray(mask), s)
        return reg + 2.0 * obj

    def tfn(t, s):
        reg, obj = tlosses.transform_param_regression_loss(
            tgeo.theta_corners(t), torch.from_numpy(gt), torch.from_numpy(mask), s)
        return reg + 2.0 * obj

    (got, got_g), (want, want_g) = _both(jfn, tfn, theta, scores)
    _close(got, want)
    for a, b in zip(got_g, want_g):
        _close(a, b)
    reg, obj = tlosses.transform_param_regression_loss(
        tgeo.theta_corners(torch.from_numpy(theta)), torch.from_numpy(gt),
        torch.from_numpy(mask), torch.from_numpy(scores))
    j_reg, j_obj = jlosses.transform_param_regression_loss(
        jgeo.theta_corners(theta), jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(scores))
    _close(float(reg), float(j_reg))
    _close(float(obj), float(j_obj))


def test_random_pairs_is_a_permutation():
    gen = torch.Generator().manual_seed(0)
    pairs = tlosses.random_pairs(gen, 10)
    assert sorted(pairs.tolist()) == list(range(10))
