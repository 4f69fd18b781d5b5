"""Geometry and rotation dropout of the PyTorch port against the JAX
package, on the inputs of ``tests/test_geometry.py``.

Tolerance 1e-5 (normalized coordinates, IoU) and 1e-4 px (pixel boxes up
to 200 px): both sides evaluate the same float32 formulas.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from loans_tpu.ops import geometry as jgeo
from loans_tpu.ops import stn as jstn
from loans_tpu.ops.rotation_dropout import rotation_dropout as j_rotation_dropout
from loans_tpu_torch.ops import geometry as geo
from loans_tpu_torch.ops.rotation_dropout import rotation_dropout


def random_theta(rng, n, rotated=True):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.2, 1.2, n)
    theta[:, 1, 1] = rng.uniform(0.2, 1.2, n)
    theta[:, 0, 2] = rng.uniform(-0.5, 0.5, n)
    theta[:, 1, 2] = rng.uniform(-0.5, 0.5, n)
    if rotated:
        theta[:, 0, 1] = rng.uniform(-0.3, 0.3, n)
        theta[:, 1, 0] = rng.uniform(-0.3, 0.3, n)
    return theta


def random_boxes(rng, n, hi):
    b = np.sort(rng.uniform(0, hi, (n, 2, 2)), axis=1).transpose(0, 2, 1)
    return b.reshape(n, 4)[:, [0, 2, 1, 3]].astype(np.float32)


def T(a):
    return torch.tensor(np.asarray(a))


def test_theta_corners_matches_jax():
    theta = random_theta(np.random.default_rng(0), 5)
    np.testing.assert_allclose(
        geo.theta_corners(T(theta)).numpy(),
        np.asarray(jgeo.theta_corners(theta)),
        atol=1e-5,
    )


def test_theta_corners_match_grid_corners():
    """The port's corners are the corner samples of the JAX grid."""
    theta = random_theta(np.random.default_rng(0), 5)
    grid = jstn.affine_grid(jnp.asarray(theta), jgeo.Size(7, 9))
    np.testing.assert_allclose(
        geo.theta_corners(T(theta)).numpy(),
        np.asarray(jgeo.grid_corners(grid)),
        atol=1e-5,
    )


@pytest.mark.parametrize("clip", [True, False])
def test_corners_to_aabb_matches_jax(clip):
    theta = random_theta(np.random.default_rng(3), 6)
    theta[0, :, 2] = [1.5, -1.4]  # partly outside the image
    corners = np.asarray(jgeo.theta_corners(theta))
    want = jgeo.corners_to_aabb(jnp.asarray(corners), jgeo.Size(100, 200), clip=clip)
    got = geo.corners_to_aabb(T(corners), geo.Size(100, 200), clip=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_identity_theta_covers_image():
    theta = np.zeros((1, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = 1.0
    theta[:, 1, 1] = 1.0
    aabb = geo.corners_to_aabb(geo.theta_corners(T(theta)), geo.Size(100, 200))
    np.testing.assert_allclose(aabb.numpy()[0], [0.0, 0.0, 100.0, 200.0], atol=1e-4)


def test_corners_to_bbox_and_scale_corners_match_jax():
    theta = random_theta(np.random.default_rng(4), 4)
    corners = np.asarray(jgeo.theta_corners(theta))
    size = (64, 48)
    np.testing.assert_allclose(
        geo.corners_to_bbox(T(corners), geo.Size(*size)).numpy(),
        np.asarray(jgeo.corners_to_bbox(jnp.asarray(corners), jgeo.Size(*size))),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        geo.scale_corners(T(corners), geo.Size(*size)).numpy(),
        np.asarray(jgeo.scale_corners(jnp.asarray(corners), jgeo.Size(*size))),
        atol=1e-4,
    )


def test_box_to_theta_matches_jax():
    boxes = random_boxes(np.random.default_rng(5), 6, 60)[:, [1, 0, 3, 2]]  # xyxy
    np.testing.assert_allclose(
        geo.box_to_theta(T(boxes), geo.Size(60, 80)).numpy(),
        np.asarray(jgeo.box_to_theta(boxes, jgeo.Size(60, 80))),
        atol=1e-5,
    )


def test_bbox_iou_matches_jax():
    rng = np.random.default_rng(1)
    a, b = random_boxes(rng, 8, 100), random_boxes(rng, 6, 100)
    b[0] = [10.0, 10.0, 10.0, 30.0]  # degenerate
    np.testing.assert_allclose(
        geo.bbox_iou(T(a), T(b)).numpy(), np.asarray(jgeo.bbox_iou(a, b)), atol=1e-5
    )


def test_elementwise_iou_matches_jax():
    rng = np.random.default_rng(2)
    a, b = random_boxes(rng, 10, 50), random_boxes(rng, 10, 50)
    np.testing.assert_allclose(
        geo.elementwise_iou(T(a), T(b)).numpy(),
        np.asarray(jgeo.elementwise_iou(a, b)),
        atol=1e-5,
    )


@pytest.mark.parametrize("ratio,train", [(0.0, True), (0.0, False), (0.3, False), (1.0, True)])
def test_rotation_dropout_matches_jax(ratio, train):
    theta = random_theta(np.random.default_rng(6), 4)
    want = j_rotation_dropout(jnp.asarray(theta), ratio, train=train)
    got = rotation_dropout(T(theta), ratio, train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_rotation_dropout_train_draw():
    """One draw per call, shared by the batch: the off-diagonals are all
    kept or all zeroed, as in the JAX package, whichever the draw gives."""
    theta = random_theta(np.random.default_rng(7), 4)
    kept = np.asarray(j_rotation_dropout(jnp.asarray(theta), 1.0, train=True))
    zeroed = np.asarray(j_rotation_dropout(jnp.asarray(theta), 0.0, train=True))
    jax_draw = np.asarray(
        j_rotation_dropout(jnp.asarray(theta), 0.5, train=True, rng=jax.random.key(0))
    )
    assert any(np.allclose(jax_draw, ref) for ref in (kept, zeroed))
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(16):
        got = rotation_dropout(T(theta), 0.5, train=True, generator=gen).numpy()
        matches = [np.allclose(got, ref, atol=1e-6) for ref in (kept, zeroed)]
        assert any(matches)
        seen.add(matches.index(True))
    assert seen == {0, 1}
    with pytest.raises(ValueError, match="generator"):
        rotation_dropout(T(theta), 0.5, train=True)
