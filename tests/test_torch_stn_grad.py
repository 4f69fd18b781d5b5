"""Gradient of the port's separable sampler against JAX's VJP.

The same numpy inputs, made from a seed, go through ``jax.vjp`` of the JAX
package's ``sample_separable`` and of its Pallas kernel
``sample_separable_pallas`` (interpret mode on the CPU, as
``tests/test_stn.py`` runs it; its backward is the same VJP), and through
the port's plain backward ``sample_separable_bwd`` and its autograd
Function.

Ties: where a sampling position lands exactly on a pixel, the hat
max(0, 1 - |p - j|) has a kink, and JAX's subgradients (abs'(0) = +1, half
at the max's tie) differ from what torch autograd gives through
``clamp(1 - |d|)``. The tie cases use sizes where every formula of the
positions is exact (out - 1 a power of two, scales and shifts dyadic), so
JAX and the port sample at the same floats; at other sizes JAX's own
positions depend on how XLA fuses ``linspace`` (an FMA or not).

Tolerances: d images 1e-5 absolute (cotangents of order 1, sums of a few
products); d theta 1e-5 relative to its largest entry — both sides sum
the same products in another order (measured: up to 1.1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # seeded sweeps instead
    given = None

from loans_tpu.ops import stn as jstn
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch.ops import stn
from loans_tpu_torch.ops.geometry import Size

IMG_ATOL = 1e-5
THETA_RTOL = 1e-5


def axis_aligned_theta(rng, n):
    theta = np.zeros((n, 2, 3), dtype=np.float32)
    theta[:, 0, 0] = rng.uniform(0.3, 1.1, n)
    theta[:, 1, 1] = rng.uniform(0.3, 1.1, n)
    theta[:, 0, 2] = rng.uniform(-0.4, 0.4, n)
    theta[:, 1, 2] = rng.uniform(-0.4, 0.4, n)
    return theta


def _tile(rows, n):
    return np.tile(np.asarray(rows, np.float32), (n, 1, 1))


CASES = {
    "random": (lambda r: (r.uniform(size=(3, 12, 10, 2)), axis_aligned_theta(r, 3)), (7, 6)),
    "border": (lambda r: (r.uniform(size=(2, 16, 18, 3)), np.array(
        [[[0.6, 0.0, 0.7], [0.0, 0.5, 0.8]], [[0.8, 0.0, -0.9], [0.0, 0.9, -1.2]]])), (7, 6)),
    "h_out_1": (lambda r: (r.uniform(size=(3, 12, 12, 2)), axis_aligned_theta(r, 3)), (1, 5)),
    "w_out_1": (lambda r: (r.uniform(size=(3, 12, 12, 2)), axis_aligned_theta(r, 3)), (5, 1)),
    # every tap outside the image: the crop and d theta are exactly 0
    "off_image": (lambda r: (r.uniform(size=(2, 12, 10, 3)), _tile([[0.5, 0, 5.0], [0, 0.5, 5.0]], 2)), (7, 6)),
    # every position on a pixel: p_i = i
    "identity_ties": (lambda r: (r.uniform(size=(2, 9, 9, 2)), _tile([[1, 0, 0], [0, 1, 0]], 2)), (9, 9)),
    # dyadic scale and shift: p = 0, 2, 4, 6, 8 (x) and 0, 1, 2, 3, 4 (y)
    "dyadic_ties": (lambda r: (r.uniform(size=(2, 9, 9, 1)), _tile([[1, 0, 0], [0, 0.5, -0.5]], 2)), (5, 5)),
    # scale 0: every output on one pixel (p = 6.215 in y, 3.555 in x), so
    # each of its taps sums all 42 outputs
    "zero_scale": (lambda r: (r.uniform(size=(2, 12, 10, 2)), _tile([[0, 0, -0.21], [0, 0, 0.13]], 2)), (7, 6)),
    # negative scales: the positions fall as the output index grows
    "flip": (lambda r: (r.uniform(size=(2, 12, 10, 3)), _tile([[-0.7, 0, 0.1], [0, -0.9, 0.05]], 2)), (7, 6)),
    # 8^2 -> 20^2: several outputs per input row and column
    "upsample": (lambda r: (r.uniform(size=(2, 8, 8, 2)), axis_aligned_theta(r, 2)), (20, 20)),
}


def _case(name, seed=0):
    make, out = CASES[name]
    rng = np.random.default_rng(seed)
    img, theta = make(rng)
    g = rng.normal(size=(img.shape[0],) + out + (img.shape[3],))
    return img.astype(np.float32), np.asarray(theta, np.float32), g.astype(np.float32), out


def _jax_vjp(fn, img, theta, g, out):
    _, vjp = jax.vjp(lambda i, t: fn(i, t, JSize(*out)), jnp.asarray(img), jnp.asarray(theta))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_theta_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_RTOL * scale)


@pytest.mark.parametrize("jax_fn", [jstn.sample_separable, jstn.sample_separable_pallas],
                         ids=["separable", "pallas_interpret"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_vjp(name, jax_fn):
    img, theta, g, out = _case(name)
    want_img, want_theta = _jax_vjp(jax_fn, img, theta, g, out)
    d_img, d_theta = stn.sample_separable_bwd(
        torch.from_numpy(img), torch.from_numpy(theta), torch.from_numpy(g), Size(*out)
    )
    np.testing.assert_allclose(d_img.numpy(), want_img, atol=IMG_ATOL)
    _assert_theta_close(d_theta.numpy(), want_theta)
    assert (d_theta.numpy()[:, [0, 1], [1, 0]] == 0).all()  # off-diagonals, as JAX


@pytest.mark.parametrize("name", ["random", "identity_ties"])
def test_autograd_function_matches_jax_vjp(name):
    """``sample_separable`` differentiates through ``SeparableSampler``,
    which computes d images only when the images need it."""
    img, theta, g, out = _case(name, seed=1)
    want_img, want_theta = _jax_vjp(jstn.sample_separable, img, theta, g, out)
    t_img = torch.from_numpy(img).requires_grad_()
    t_theta = torch.from_numpy(theta).requires_grad_()
    (stn.sample_separable(t_img, t_theta, Size(*out)) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t_img.grad.numpy(), want_img, atol=IMG_ATOL)
    _assert_theta_close(t_theta.grad.numpy(), want_theta)

    only_theta = torch.from_numpy(theta).requires_grad_()
    images = torch.from_numpy(img)
    (stn.sample_separable(images, only_theta, Size(*out)) * torch.from_numpy(g)).sum().backward()
    assert images.grad is None
    _assert_theta_close(only_theta.grad.numpy(), want_theta)


def test_finite_difference_theta_away_from_ties():
    """Central differences of the crop in float64 (the general sampler,
    the same function for axis-aligned theta, all in float64) against the
    analytic d theta, at random theta (no position within 1e-3 px of a
    pixel, checked). Step 1e-4: the crop is piecewise linear in p, so the
    difference is exact up to rounding while no tap changes."""
    img, theta, g, out = _case("random", seed=2)
    h, w = img.shape[1:3]
    for scale, shift, n_in, n_out in ((theta[:, 1, 1], theta[:, 1, 2], h, out[0]),
                                      (theta[:, 0, 0], theta[:, 0, 2], w, out[1])):
        u = np.linspace(-1.0, 1.0, n_out)
        p = (scale[:, None] * u + shift[:, None] + 1.0) * 0.5 * (n_in - 1)
        assert np.abs(p - np.round(p)).min() > 1e-3
    images = torch.from_numpy(img).double()
    gd = torch.from_numpy(g).double()

    def loss(t):
        crop = stn.sample_grid(images, stn.affine_grid(t, Size(*out)))
        return float((crop * gd).sum())

    _, d_theta = stn.sample_separable_bwd(
        torch.from_numpy(img), torch.from_numpy(theta), torch.from_numpy(g), Size(*out)
    )
    eps = 1e-4
    numeric = np.zeros_like(theta, dtype=np.float64)
    base = torch.from_numpy(theta).double()
    for r, c in ((0, 0), (0, 2), (1, 1), (1, 2)):
        for b in range(theta.shape[0]):
            plus, minus = base.clone(), base.clone()
            plus[b, r, c] += eps
            minus[b, r, c] -= eps
            numeric[b, r, c] = (loss(plus) - loss(minus)) / (2 * eps)
    np.testing.assert_allclose(d_theta.numpy(), numeric, rtol=0,
                               atol=1e-4 * np.abs(numeric).max())


def test_naive_autograd_differs_from_jax_at_ties():
    """Autograd through the naive hat clamp(1 - |d|) takes torch's
    subgradients (abs'(0) = 0, clamp passes the whole gradient at the
    tie) and misses JAX's d theta at the identity; ``SeparableSampler``
    holds it."""
    img, theta, g, out = _case("identity_ties", seed=3)
    _, want_theta = _jax_vjp(jstn.sample_separable, img, theta, g, out)
    n, h, w, c = img.shape
    t_naive = torch.from_numpy(theta).requires_grad_()
    ky = stn._hat(stn._offsets(t_naive[:, 1, 1], t_naive[:, 1, 2], out[0], h))
    kx = stn._hat(stn._offsets(t_naive[:, 0, 0], t_naive[:, 0, 2], out[1], w))
    tmp = torch.bmm(ky, torch.from_numpy(img).reshape(n, h, w * c)).reshape(n, out[0], w, c)
    naive = torch.einsum("nwq,nhqc->nhwc", kx, tmp)
    (naive * torch.from_numpy(g)).sum().backward()
    scale = np.abs(want_theta).max()
    assert np.abs(t_naive.grad.numpy() - want_theta).max() > 0.1 * scale

    t_fn = torch.from_numpy(theta).requires_grad_()
    (stn.sample_separable(torch.from_numpy(img), t_fn, Size(*out)) * torch.from_numpy(g)).sum().backward()
    _assert_theta_close(t_fn.grad.numpy(), want_theta)


def test_hat_grad_convention():
    """d hat/dp at p = 2 for pixels j = 0..4, JAX's values."""
    d = 2.0 - torch.arange(5, dtype=torch.float32)
    np.testing.assert_array_equal(stn._hat_grad(d).numpy(), [0.0, -0.5, -1.0, 0.5, 0.0])
    want = jax.jacfwd(lambda p: jnp.maximum(0.0, 1.0 - jnp.abs(p - jnp.arange(5.0))))(2.0)
    np.testing.assert_array_equal(stn._hat_grad(d).numpy(), np.asarray(want))


def test_nan_theta_gives_nan_gradient():
    img, theta, g, out = _case("random", seed=4)
    theta[1, 1, 1] = np.nan
    d_img, d_theta = stn.sample_separable_bwd(
        torch.from_numpy(img), torch.from_numpy(theta), torch.from_numpy(g), Size(*out)
    )
    assert np.isnan(d_theta.numpy()[1, [0, 0, 1, 1], [0, 2, 1, 2]]).all()
    assert np.isfinite(d_theta.numpy()[[0, 2]]).all()
    assert np.isnan(d_img.numpy()[1]).all() and np.isfinite(d_img.numpy()[[0, 2]]).all()


def test_backward_kernels_refuse_cpu_tensors():
    img, theta, g, out = _case("random")
    img, theta, g = torch.from_numpy(img), torch.from_numpy(theta), torch.from_numpy(g)
    before = (stn.sample_separable_kernel.launches_bwd_theta,
              stn.sample_separable_kernel.launches_bwd_images)
    with pytest.raises(ValueError, match="CUDA"):
        stn.separable_sampler_bwd_theta(img, theta, g)
    with pytest.raises(ValueError, match="CUDA"):
        stn.separable_sampler_bwd_images(theta, g, tuple(img.shape))
    assert before == (stn.sample_separable_kernel.launches_bwd_theta,
                      stn.sample_separable_kernel.launches_bwd_images)


def _reach_ranges(pos: np.ndarray, size: int) -> list[tuple[int, int]]:
    """The d images kernel's reach ranges (``csrc/separable_sampler.cu``)
    in numpy float32: each output k files itself under its taps floor(p_k)
    and floor(p_k) + 1 where |p_k - x| < 1, by min and max."""
    ranges = [(len(pos), 0)] * size
    for k, p in enumerate(pos):
        if not np.isfinite(np.floor(p)):
            continue
        for x in (int(np.floor(p)), int(np.floor(p)) + 1):
            if 0 <= x < size and abs(np.float32(p - np.float32(x))) < 1.0:
                lo, hi = ranges[x]
                ranges[x] = (min(lo, k), max(hi, k + 1))
    return ranges


def _check_separable_reach(scale: float, shift: float, out: int, size: int) -> None:
    """The d images kernel's reach ranges hold exactly the outputs whose
    hat is non-zero on each input index, the plain version's ky: the taps
    floor(p) and floor(p) + 1 find them all, and as the positions are
    monotone they are one contiguous range."""
    t = torch.tensor([scale], dtype=torch.float32)
    d = stn._offsets(t, torch.tensor([shift], dtype=torch.float32), out, size)[0]  # p_i - x
    live = (stn._hat(d) != 0).numpy()
    pos = d[:, 0].numpy()  # p_i - 0
    for x, (lo, hi) in enumerate(_reach_ranges(pos, size)):
        assert list(np.flatnonzero(live[:, x])) == list(range(lo, hi)), (scale, shift, out, size, x)


if given is not None:
    @settings(max_examples=150, deadline=None, database=None)
    @given(scale=st.floats(-2.0, 2.0, width=32), shift=st.floats(-2.0, 2.0, width=32),
           out=st.integers(1, 40), size=st.integers(1, 40))
    def test_separable_reach_is_exactly_the_live_outputs(scale, shift, out, size):
        _check_separable_reach(scale, shift, out, size)
else:
    @pytest.mark.parametrize("seed", range(150))
    def test_separable_reach_is_exactly_the_live_outputs(seed):
        r = np.random.default_rng(seed)
        scale = 0.0 if seed % 10 == 0 else float(r.uniform(-2, 2))
        _check_separable_reach(scale, float(r.uniform(-2, 2)), int(r.integers(1, 41)), int(r.integers(1, 41)))
