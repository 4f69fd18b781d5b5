"""The port's rotated (general-affine) crop against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package's
``sample_rotated_pallas`` (its Pallas kernel in interpret mode on the CPU,
as ``tests/test_stn.py`` runs it; its backward is the dense VJP
``_rotated_dense_bwd_impl``), ``sample_rotated_dense`` and
``sample_grid(affine_grid(...))``, and through the port's plain version
``sample_rotated``, its analytic backward ``sample_rotated_bwd`` and the
autograd Function ``RotatedSampler``.

Ties: where a sampling position lands exactly on a pixel, JAX's rotated
VJP takes hat'(0) = 0, so such a position moves nothing; the separable
crop's VJP (JAX autodiff of ``maximum(0, 1 - abs(d))``) does not. The tie
cases use sizes where every formula of the positions is exact (out - 1 a
power of two, theta dyadic), so JAX and the port sample at the same
floats.

Tolerances: crops 1e-5 absolute (images in [0, 1]; float32 weights from
the same formula, positions summed in another association order by the
Pallas kernel); d images 1e-5 absolute (cotangents of order 1, sums of a
few products); d theta 1e-5 relative to its largest entry (both sides sum
the same products in another order; measured up to 6.3e-7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from loans_tpu.ops import stn as jstn
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch.cli import bench_samplers
from loans_tpu_torch.ops import stn
from loans_tpu_torch.ops.geometry import Size

ATOL = 1e-5
THETA_RTOL = 1e-5


def rotated_theta(rng, n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.1, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.1, n)
    theta[:, 0, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 1, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 0, 1] = rng.uniform(-0.3, 0.3, n)
    theta[:, 1, 0] = rng.uniform(-0.3, 0.3, n)
    return theta


def _tile(rows, n):
    return np.tile(np.asarray(rows, np.float32), (n, 1, 1))


def _nan_theta(rng):
    """NaN in row 0 of image 0 (px NaN) and in row 1 of image 2 (py NaN)."""
    theta = rotated_theta(rng, 3)
    theta[0, 0, 1] = np.nan
    theta[2, 1, 2] = np.nan
    return theta


CASES = {
    "random": (lambda r: (r.uniform(size=(4, 24, 20, 3)), rotated_theta(r, 4)), (9, 11)),
    # straddling the bottom-right border, and half outside on the top-left
    "border": (lambda r: (r.uniform(size=(2, 16, 18, 3)), np.array(
        [[[0.6, 0.2, 0.7], [0.15, 0.5, 0.8]], [[0.8, -0.25, -0.9], [0.2, 0.9, -1.2]]])), (7, 6)),
    "off_image": (lambda r: (r.uniform(size=(2, 12, 12, 2)), _tile([[0.5, 0.1, 5.0], [0.1, 0.5, 5.0]], 2)), (4, 4)),
    "h_out_1": (lambda r: (r.uniform(size=(3, 12, 12, 2)), rotated_theta(r, 3)), (1, 5)),
    "w_out_1": (lambda r: (r.uniform(size=(3, 12, 12, 2)), rotated_theta(r, 3)), (4, 1)),
    # every position on a pixel: p = j
    "identity_ties": (lambda r: (r.uniform(size=(2, 9, 9, 2)), _tile([[1, 0, 0], [0, 1, 0]], 2)), (9, 9)),
    # dyadic rotation: positions on pixels and on half pixels
    "dyadic_ties": (lambda r: (r.uniform(size=(2, 9, 9, 1)), _tile([[0.5, 0.25, 0], [-0.25, 0.5, 0]], 2)), (5, 5)),
    "nan": (lambda r: (r.uniform(size=(3, 12, 10, 2)), _nan_theta(r)), (5, 6)),
    # neighbouring output pixels share taps
    "upsample": (lambda r: (r.uniform(size=(2, 9, 9, 3)), rotated_theta(r, 2)), (20, 20)),
    "c4": (lambda r: (r.uniform(size=(2, 12, 10, 4)), rotated_theta(r, 2)), (5, 6)),
}
TIES = ("identity_ties",)


def _case(name, seed=0):
    make, out = CASES[name]
    rng = np.random.default_rng(seed)
    img, theta = make(rng)
    g = rng.normal(size=(img.shape[0],) + out + (img.shape[3],))
    return img.astype(np.float32), np.asarray(theta, np.float32), g.astype(np.float32), out


def _jax_general(img, theta, out):
    return jstn.sample_grid(img, jstn.affine_grid(theta, out))


def _jax_vjp(fn, img, theta, g, out):
    _, vjp = jax.vjp(lambda i, t: fn(i, t, JSize(*out)), jnp.asarray(img), jnp.asarray(theta))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_theta_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.nanmax(np.abs(want), initial=0.0)), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_RTOL * scale)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("jax_fn", [jstn.sample_rotated_pallas, jstn.sample_rotated_dense, _jax_general],
                         ids=["rotated_pallas_interpret", "rotated_dense", "general"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name, jax_fn):
    img, theta, _, out = _case(name)
    got = stn.sample_rotated(*_torch(img, theta), Size(*out))
    assert got.is_contiguous() and got.dtype == torch.float32
    want = np.asarray(jax_fn(jnp.asarray(img), jnp.asarray(theta), JSize(*out)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_nan_theta_gives_nan_crop_where_a_position_is_nan():
    img, theta, _, out = _case("nan")
    got = stn.sample_rotated(*_torch(img, theta), Size(*out)).numpy()
    assert np.isnan(got[[0, 2]]).all() and np.isfinite(got[1]).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_vjp(name):
    img, theta, g, out = _case(name)
    want_img, want_theta = _jax_vjp(jstn.sample_rotated_pallas, img, theta, g, out)
    d_img, d_theta = stn.sample_rotated_bwd(*_torch(img, theta, g), Size(*out))
    np.testing.assert_allclose(d_img.numpy(), want_img, atol=ATOL)
    _assert_theta_close(d_theta.numpy(), want_theta)
    if name in TIES:
        assert not d_theta.any() and not np.asarray(want_theta).any()


@pytest.mark.parametrize("name", ["random", "border", "identity_ties", "dyadic_ties"])
def test_autograd_function_matches_jax_vjp(name):
    """``sample_rotated`` differentiates through ``RotatedSampler``, which
    computes d images only when the images need it."""
    img, theta, g, out = _case(name, seed=1)
    want_img, want_theta = _jax_vjp(jstn.sample_rotated_pallas, img, theta, g, out)
    t_img, t_theta = (t.requires_grad_() for t in _torch(img, theta))
    (stn.spatial_transform(t_img, t_theta, Size(*out), method="rotated") * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t_img.grad.numpy(), want_img, atol=ATOL)
    _assert_theta_close(t_theta.grad.numpy(), want_theta)

    images, only_theta = _torch(img, theta)
    only_theta.requires_grad_()
    (stn.sample_rotated(images, only_theta, Size(*out)) * torch.from_numpy(g)).sum().backward()
    assert images.grad is None
    _assert_theta_close(only_theta.grad.numpy(), want_theta)


def test_finite_difference_theta_away_from_ties():
    """Central differences of the crop in float64 (the general sampler, all
    in float64) against the analytic d theta, all six entries, at random
    rotated theta whose positions all lie at least 5e-3 px from a pixel
    (checked). Step 1e-5, which moves a position by at most 3e-4 px: the
    crop is piecewise linear in the positions, so the difference is exact
    up to rounding while no tap changes."""
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(2, 16, 14, 2)).astype(np.float32)
    theta = rotated_theta(rng, 2)
    out = (5, 6)
    g = rng.normal(size=(2,) + out + (2,)).astype(np.float32)
    px, py = stn._rotated_positions(torch.from_numpy(theta), Size(*out), 16, 14)
    for p in (px.numpy(), py.numpy()):
        assert np.abs(p - np.round(p)).min() > 5e-3
    images, gd = torch.from_numpy(img).double(), torch.from_numpy(g).double()

    def loss(t):
        return float((stn.sample_grid(images, stn.affine_grid(t, Size(*out))) * gd).sum())

    _, d_theta = stn.sample_rotated_bwd(*_torch(img, theta, g), Size(*out))
    eps = 1e-5
    numeric = np.zeros_like(theta, dtype=np.float64)
    base = torch.from_numpy(theta).double()
    for b in range(theta.shape[0]):
        for r in range(2):
            for c in range(3):
                plus, minus = base.clone(), base.clone()
                plus[b, r, c] += eps
                minus[b, r, c] -= eps
                numeric[b, r, c] = (loss(plus) - loss(minus)) / (2 * eps)
    np.testing.assert_allclose(d_theta.numpy(), numeric, rtol=0, atol=1e-4 * np.abs(numeric).max())


def test_rotated_and_separable_conventions_differ_at_ties():
    """At the identity every position is a tie. JAX's rotated VJP gives d
    theta exactly 0 there; its separable VJP does not. The port's rotated
    backward matches the first and its separable backward the second."""
    img, theta, g, out = _case("identity_ties", seed=3)
    _, rotated_want = _jax_vjp(jstn.sample_rotated_pallas, img, theta, g, out)
    _, separable_want = _jax_vjp(jstn.sample_separable, img, theta, g, out)
    assert not rotated_want.any()
    assert np.abs(separable_want).max() > 1.0

    _, rotated_got = stn.sample_rotated_bwd(*_torch(img, theta, g), Size(*out))
    _, separable_got = stn.sample_separable_bwd(*_torch(img, theta, g), Size(*out))
    assert not rotated_got.any()
    _assert_theta_close(separable_got.numpy(), separable_want)


def test_hat_grad_dense_convention():
    """hat' at p - j = 2, 1, 0.5, 0, -0.5, -1: the dense VJP's rule, 0 at
    the tie and at the hat's corners (the separable rule gives -1 and ∓0.5
    there)."""
    d = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, float("nan")])
    np.testing.assert_array_equal(stn._hat_grad_dense(d).numpy(), [0.0, 0.0, -1.0, 0.0, 1.0, 0.0, 0.0])
    assert stn._hat_grad(torch.tensor(0.0)) == -1.0


def test_spatial_transform_rotated_matches_general_for_axis_aligned_theta():
    """With zero off-diagonals the rotated crop is the separable one."""
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(3, 16, 14, 3)).astype(np.float32)
    theta = rotated_theta(rng, 3)
    theta[:, [0, 1], [1, 0]] = 0.0
    args = (*_torch(img, theta), Size(7, 9))
    np.testing.assert_allclose(stn.spatial_transform(*args, method="rotated").numpy(),
                               stn.spatial_transform(*args, method="separable").numpy(), atol=ATOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    img, theta, g, out = _case("random")
    img, theta, g = _torch(img, theta, g)
    counters = ("launches", "launches_bwd_theta", "launches_bwd_images")
    before = [getattr(stn.sample_rotated_kernel, k) for k in counters]
    for call in (lambda: stn.sample_rotated_kernel(img, theta, Size(*out)),
                 lambda: stn.spatial_transform(img, theta, Size(*out), method="rotated_pallas"),
                 lambda: stn.rotated_sampler_bwd_theta(img, theta, g),
                 lambda: stn.rotated_sampler_bwd_images(theta, g, tuple(img.shape))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [getattr(stn.sample_rotated_kernel, k) for k in counters] == before


def test_bench_samplers_refuses_a_device_that_is_not_cuda():
    """The sampler bench times the card only: it does not fall back."""
    with pytest.raises(SystemExit, match="CUDA"):
        bench_samplers.main(["--device", "cpu"])
