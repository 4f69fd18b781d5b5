"""Spatial transformer of the PyTorch port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart. The JAX Pallas kernel runs in interpret mode on the
CPU, as ``tests/test_stn.py`` runs it. Tolerance 1e-5 absolute on images
in [0, 1]: both sides compute float32 bilinear weights from the same
formula; only the summation order of the contractions differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from loans_tpu.ops import stn as jstn
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch.models import Localizer
from loans_tpu_torch.ops import stn
from loans_tpu_torch.ops.geometry import Size

ATOL = 1e-5


def axis_aligned_theta(rng, n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.1, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.1, n)
    theta[:, 0, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 1, 2] = rng.uniform(-0.4, 0.4, n)
    return theta


def rotated_theta(rng, n):
    theta = axis_aligned_theta(rng, n)
    theta[:, 0, 1] = rng.uniform(-0.3, 0.3, n)
    theta[:, 1, 0] = rng.uniform(-0.3, 0.3, n)
    return theta


def border_theta():
    """A crop straddling the bottom-right border and one half outside on
    the top-left, so zero padding matters."""
    return np.array(
        [
            [[0.6, 0.0, 0.7], [0.0, 0.5, 0.8]],
            [[0.8, 0.0, -0.9], [0.0, 0.9, -1.2]],
        ],
        dtype=np.float32,
    )


def identity_theta(n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = 1.0
    theta[:, 1, 1] = 1.0
    return theta


def _jax(fn, img, theta, out):
    return np.asarray(fn(jnp.asarray(img), jnp.asarray(theta), JSize(*out)))


def _port(fn, img, theta, out):
    return fn(torch.from_numpy(img), torch.from_numpy(theta), Size(*out)).numpy()


def nan_theta(rng):
    """NaN theta11 in image 1: py is NaN on every row of it."""
    theta = axis_aligned_theta(rng, 3)
    theta[1, 1, 1] = np.nan
    return theta


def dyadic_theta(n):
    """Positions on pixels and on half pixels, exact in float32 at 9 -> 5."""
    return np.tile(np.array([[[0.5, 0.0, 0.25], [0.0, 0.5, -0.25]]], np.float32), (n, 1, 1))


CASES = {
    "random": (lambda rng: (rng.uniform(size=(4, 24, 20, 3)), axis_aligned_theta(rng, 4)), (9, 11)),
    "border": (lambda rng: (rng.uniform(size=(2, 16, 18, 3)), border_theta()), (7, 6)),
    "h_out_1": (lambda rng: (rng.uniform(size=(3, 12, 12, 2)), axis_aligned_theta(rng, 3)), (1, 5)),
    "w_out_1": (lambda rng: (rng.uniform(size=(3, 12, 12, 2)), axis_aligned_theta(rng, 3)), (4, 1)),
    "nan": (lambda rng: (rng.uniform(size=(3, 10, 12, 3)), nan_theta(rng)), (6, 7)),
    "dyadic_ties": (lambda rng: (rng.uniform(size=(2, 9, 9, 2)), dyadic_theta(2)), (5, 5)),
    # consecutive output rows and columns share input pixels
    "upsample": (lambda rng: (rng.uniform(size=(2, 9, 9, 3)), axis_aligned_theta(rng, 2)), (20, 20)),
    "c1": (lambda rng: (rng.uniform(size=(3, 16, 14, 1)), axis_aligned_theta(rng, 3)), (7, 9)),
    "c4": (lambda rng: (rng.uniform(size=(2, 16, 14, 4)), axis_aligned_theta(rng, 2)), (6, 8)),
}


def _case(name, seed=0):
    make, out = CASES[name]
    img, theta = make(np.random.default_rng(seed))
    return img.astype(np.float32), theta.astype(np.float32), out


@pytest.mark.parametrize("name", sorted(CASES))
def test_separable_matches_jax_separable(name):
    img, theta, out = _case(name)
    np.testing.assert_allclose(
        _port(stn.sample_separable, img, theta, out),
        _jax(jstn.sample_separable, img, theta, out),
        atol=ATOL,
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_separable_matches_jax_pallas_kernel(name):
    img, theta, out = _case(name)
    np.testing.assert_allclose(
        _port(stn.sample_separable, img, theta, out),
        _jax(jstn.sample_separable_pallas, img, theta, out),
        atol=ATOL,
    )


def test_identity_theta_resamples_image():
    img = np.random.default_rng(3).uniform(size=(2, 10, 10, 3)).astype(np.float32)
    theta = identity_theta(2)
    got = _port(stn.sample_separable, img, theta, (10, 10))
    np.testing.assert_allclose(got, img, atol=ATOL)
    np.testing.assert_allclose(
        got, _jax(jstn.sample_separable_pallas, img, theta, (10, 10)), atol=ATOL
    )


def test_off_image_theta_reads_zero():
    img = np.ones((1, 8, 8, 1), dtype=np.float32)
    theta = np.array([[[0.5, 0.0, 5.0], [0.0, 0.5, 5.0]]], dtype=np.float32)
    for fn in (stn.sample_separable, lambda i, t, o: stn.sample_grid(i, stn.affine_grid(t, o))):
        np.testing.assert_allclose(_port(fn, img, theta, (4, 4)), 0.0, atol=1e-6)


def test_affine_grid_matches_jax():
    theta = rotated_theta(np.random.default_rng(4), 3)
    got = stn.affine_grid(torch.from_numpy(theta), Size(6, 9)).numpy()
    want = np.asarray(jstn.affine_grid(jnp.asarray(theta), JSize(6, 9)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("rotated", [False, True])
def test_sample_grid_matches_jax(rotated):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(3, 16, 18, 3)).astype(np.float32)
    theta = (rotated_theta if rotated else axis_aligned_theta)(rng, 3)
    theta[0] = border_theta()[0]
    grid = jstn.affine_grid(jnp.asarray(theta), JSize(8, 10))
    want = np.asarray(jstn.sample_grid(jnp.asarray(img), grid))
    got = stn.sample_grid(torch.from_numpy(img), torch.from_numpy(np.array(grid))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_spatial_transform_general_matches_separable():
    img, theta, out = _case("random", seed=6)
    general = _port(
        lambda i, t, o: stn.spatial_transform(i, t, o, method="general"), img, theta, out
    )
    separable = _port(
        lambda i, t, o: stn.spatial_transform(i, t, o, method="separable"), img, theta, out
    )
    np.testing.assert_allclose(general, separable, atol=1e-4)


@pytest.mark.parametrize("jax_method", ["rotated", "rotated_pallas"])
def test_spatial_transform_rotated_matches_jax(jax_method):
    """The port's ``method="rotated"`` (the plain version of the rotated
    crop's kernels) against JAX's dense and Pallas rotated crops, at
    rotated theta with one crop straddling the border."""
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(3, 16, 18, 3)).astype(np.float32)
    theta = rotated_theta(rng, 3)
    theta[0] = border_theta()[0]
    theta[0, 0, 1], theta[0, 1, 0] = 0.2, -0.15
    np.testing.assert_allclose(
        _port(lambda i, t, o: stn.spatial_transform(i, t, o, method="rotated"), img, theta, (8, 10)),
        _jax(lambda i, t, o: jstn.spatial_transform(i, t, o, method=jax_method), img, theta, (8, 10)),
        atol=ATOL,
    )


def test_unknown_method_raises():
    img, theta, out = _case("random")
    with pytest.raises(ValueError, match="unknown"):
        _port(lambda i, t, o: stn.spatial_transform(i, t, o, method="nope"), img, theta, out)


def test_kernel_refuses_cpu_tensors():
    img, theta, out = _case("random")
    before = stn.sample_separable_kernel.launches
    for method in (stn.sample_separable_kernel,
                   lambda i, t, o: stn.spatial_transform(i, t, o, method="pallas")):
        with pytest.raises(ValueError, match="CUDA"):
            _port(method, img, theta, out)
    assert stn.sample_separable_kernel.launches == before


def test_auto_sampler_choice():
    cpu = torch.zeros(1, 8, 8, 3)
    assert Localizer(n_layers=18).sampler_method(cpu) == "separable"
    assert Localizer(n_layers=18, rotation_dropout_ratio=0.5).sampler_method(cpu) == "general"
    assert Localizer(n_layers=18, sampler="pallas").sampler_method(cpu) == "pallas"
    rotated = Localizer(n_layers=18, rotation_dropout_ratio=0.5, sampler="rotated_pallas")
    assert rotated.sampler_method(cpu) == "rotated_pallas"
