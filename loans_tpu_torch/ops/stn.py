"""Spatial transformer: affine grid generation + bilinear crop (port of
``loans_tpu/ops/stn.py``).

Five implementations of one function, with the JAX package's names:

1. ``sample_grid`` over ``affine_grid`` — general gather-based bilinear
   sampling of a materialized grid, any affine theta. The correctness
   reference and ``method="general"``.
2. ``sample_separable`` — the plain PyTorch version of the axis-aligned
   crop: hat-weight matrices built in float32, then two batched matmuls
   in float32. ``method="separable"``.
3. ``sample_separable_kernel`` — the same function as hand-written CUDA
   kernels (``csrc/separable_sampler.cu``), replacing the Pallas kernel
   ``loans_tpu/ops/stn.py::_separable_kernel`` and, for the backward, the
   JAX VJP of ``sample_separable`` that its ``custom_vjp`` uses.
   ``method="pallas"``.
4. ``sample_rotated`` — the plain PyTorch version of the general-affine
   crop: a 4-tap bilinear gather at positions formed in one fixed order
   (``_rotated_positions``). ``method="rotated"``; the JAX package's
   dense per-row form of the same function (``sample_rotated_dense``) was
   a device for the TPU's matrix unit and is not ported.
5. ``sample_rotated_kernel`` — the same function as hand-written CUDA
   kernels (``csrc/rotated_sampler.cu``), replacing the Pallas kernel
   ``loans_tpu/ops/stn.py::_rotated_kernel`` and, for the backward, the
   analytic VJP ``_rotated_dense_bwd_impl`` that its ``custom_vjp`` runs.
   ``method="rotated_pallas"``.

Each pair of a plain version and its kernels is one
``torch.autograd.Function`` (``SeparableSampler``, ``RotatedSampler``)
whose backward is analytic, never autograd through the hat weights: the
plain backward on the CPU, the kernels on the card. The two take JAX's
subgradients at ties, which differ between them (see ``_hat_grad`` and
``_hat_grad_dense``).

Coordinate convention (chainer / cuDNN SpatialTf):
  * grid channels are (x, y) in [-1, 1]; (-1, -1) is the top-left corner.
  * pixel mapping is align-corners: px = (x + 1) / 2 * (W - 1).
  * out-of-bounds samples read zeros, with bilinear weights tapering to
    zero over the one-pixel border.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from loans_tpu_torch.ops import _cuda
from loans_tpu_torch.ops.geometry import Size

# The kernels index inside an image and inside a crop in 32 bits.
_MAX_IMAGE_ELEMENTS = 2**31 - 1


def _positions(out_dim: int, device) -> torch.Tensor:
    """Normalized output positions u_i = -1 + step * i, float32.

    ``step`` is 0 for a single output (u = -1, as ``linspace(-1, 1, 1)``
    gives). The CUDA kernels evaluate the same expression in the same
    order, so all versions sample at bit-identical positions.
    """
    step = 2.0 / (out_dim - 1) if out_dim > 1 else 0.0
    i = torch.arange(out_dim, dtype=torch.float32, device=device)
    return -1.0 + step * i


def affine_grid(theta: torch.Tensor, out_size: Size) -> torch.Tensor:
    """Materialize the sampling grid.

    Args:
      theta: (N, 2, 3) affine params; row 0 produces x, row 1 produces y.
      out_size: crop size (H_out, W_out).

    Returns:
      (N, H_out, W_out, 2) grid with channels (x, y) in [-1, 1].
    """
    h, w = int(out_size.height), int(out_size.width)
    ys = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype, device=theta.device)
    gx = xs[None, None, :]
    gy = ys[None, :, None]
    t = theta[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    grid = t[:, :, 0] * gx + t[:, :, 1] * gy + t[:, :, 2]  # (N, 2, H, W)
    return grid.permute(0, 2, 3, 1)


def sample_grid(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """General bilinear sampling of NHWC images at grid points, zero
    padding outside the image.

    Args:
      images: (N, H, W, C).
      grid: (N, H_out, W_out, 2) with channels (x, y) in [-1, 1].

    Returns:
      (N, H_out, W_out, C) crops.
    """
    n, h, w, c = images.shape
    px = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    py = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None].to(images.dtype)
    wy = (py - y0)[..., None].to(images.dtype)
    flat = images.reshape(n, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(n, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(grid.shape[:3] + (c,))
        return vals * valid[..., None].to(images.dtype)

    top = gather(y0, x0) * (1.0 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1.0 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _offsets(
    scale: torch.Tensor, shift: torch.Tensor, out_dim: int, in_dim: int
) -> torch.Tensor:
    """d[n, i, j] = p_i - j for one separable axis, float32 (N, out, in).

    Output position i samples input pixel
    p_i = (scale * u_i + shift + 1) * (in - 1) / 2.
    """
    u = _positions(out_dim, scale.device)
    p = (
        scale.float()[:, None] * u[None, :] + shift.float()[:, None] + 1.0
    ) * (0.5 * (in_dim - 1))
    j = torch.arange(in_dim, dtype=torch.float32, device=scale.device)
    return p[:, :, None] - j


def _hat(d: torch.Tensor) -> torch.Tensor:
    """Bilinear hat weight max(0, 1 - |d|); zero padding outside the
    image follows from j ranging over the image only."""
    return (1.0 - d.abs()).clamp(min=0.0)


def _hat_grad(d: torch.Tensor) -> torch.Tensor:
    """d hat / dp at d = p - j, the separable crop's convention: JAX's
    subgradients of ``maximum(0, 1 - abs(d))`` under autodiff. abs'(0) =
    +1, so -1 at d = 0; the maximum ties with 0 at |d| = 1 and passes
    half, -0.5 * sign(d); -sign(d) inside; 0 beyond. A NaN offset gives
    NaN."""
    s = torch.where(d >= 0, 1.0, -1.0)
    a = d.abs()
    grad = torch.where(a < 1.0, -s, torch.where(a == 1.0, -0.5 * s, 0.0))
    return torch.where(torch.isnan(d), d, grad)


def _hat_grad_dense(d: torch.Tensor) -> torch.Tensor:
    """d hat / dp at d = p - j, the rotated crop's convention: the rule
    that JAX's hand-written VJP of the dense rotated sampler uses
    (``_rotated_dense_bwd_impl``), -sign(d) on |d| < 1 and 0 elsewhere.
    So 0 at d = 0 (a position exactly on a pixel moves nothing), 0 at
    |d| >= 1 and 0 for a NaN offset."""
    return torch.where(d.abs() < 1.0, -torch.sign(d), 0.0)


def _separable_plain(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    n, h, w, c = images.shape
    h_out, w_out = int(out_size.height), int(out_size.width)
    ky = _hat(_offsets(theta[:, 1, 1], theta[:, 1, 2], h_out, h))
    kx = _hat(_offsets(theta[:, 0, 0], theta[:, 0, 2], w_out, w))
    # Contract input rows, then input columns.
    tmp = torch.bmm(ky, images.float().reshape(n, h, w * c))
    tmp = tmp.reshape(n, h_out, w, c)
    # einsum returns a permuted view; downstream convolutions (the CPU's
    # backward in particular, off by ~3e-3 on that layout) want NHWC, as the
    # kernel writes it
    out = torch.einsum("nwq,nhqc->nhwc", kx, tmp).contiguous()
    return out.to(images.dtype)


def sample_separable_bwd(
    images: torch.Tensor,
    theta: torch.Tensor,
    g: torch.Tensor,
    out_size: Size,
    need_images: bool = True,
    need_theta: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Plain analytic VJP of ``sample_separable`` — the plain version of
    the backward kernels, following the JAX VJP's dense formulation.

    With out = ky · img · kxᵀ per channel:
      * d img = kyᵀ · g · kx;
      * dp_y[i] = Σ_y (g · kx · imgᵀ)[i, y] · hat'(p_i − y), and
        dθ11 = (H−1)/2 · Σ_i dp_y[i] · u_i, dθ12 = (H−1)/2 · Σ_i dp_y[i];
        x alike with W and u_j; dθ01 = dθ10 = 0.

    Args:
      images: (N, H, W, C); theta: (N, 2, 3); g: (N, H_out, W_out, C), the
        cotangent of the crop.
      out_size: crop size.
      need_images, need_theta: which gradients to compute.

    Returns:
      (d images in the images' dtype or None, d theta in theta's dtype or
      None).
    """
    n, h, w, c = images.shape
    h_out, w_out = int(out_size.height), int(out_size.width)
    dy = _offsets(theta[:, 1, 1], theta[:, 1, 2], h_out, h)
    dx = _offsets(theta[:, 0, 0], theta[:, 0, 2], w_out, w)
    ky, kx = _hat(dy), _hat(dx)
    g = g.float()
    dtmp = torch.einsum("nwq,nhwc->nhqc", kx, g)  # (N, h_out, W, C)
    d_images = d_theta = None
    if need_images:
        d_images = torch.bmm(ky.transpose(1, 2), dtmp.reshape(n, h_out, w * c))
        d_images = d_images.reshape(n, h, w, c).to(images.dtype)
    if need_theta:
        img = images.float().reshape(n, h, w * c)
        tmp = torch.bmm(ky, img).reshape(n, h_out, w, c)
        dkx = torch.einsum("nhwc,nhqc->nwq", g, tmp)  # (N, w_out, W)
        dky = torch.bmm(dtmp.reshape(n, h_out, w * c), img.transpose(1, 2))
        dpy = (dky * _hat_grad(dy)).sum(-1) * (0.5 * (h - 1))  # (N, h_out)
        dpx = (dkx * _hat_grad(dx)).sum(-1) * (0.5 * (w - 1))  # (N, w_out)
        uy = _positions(h_out, theta.device)
        ux = _positions(w_out, theta.device)
        zero = torch.zeros_like(dpy[:, 0])
        d_theta = torch.stack([
            torch.stack([(dpx * ux).sum(1), zero, dpx.sum(1)], dim=1),
            torch.stack([zero, (dpy * uy).sum(1), dpy.sum(1)], dim=1),
        ], dim=1).to(theta.dtype)
    return d_images, d_theta


# -- the rotated crop, plain version ------------------------------------------
def _rotated_positions(
    theta: torch.Tensor, out_size: Size, h: int, w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel positions (px, py), each (N, H_out, W_out) float32, sampled by
    output (i, j):

      px = (((θ00·u_j + θ01·v_i) + θ02) + 1) · (W − 1)/2, py alike with
      row 1 and H,

    in that association order, the dense VJP's (``loans_tpu/ops/stn.py``
    ``_rotated_dense_bwd_impl``), with u, v from ``_positions``. The CUDA
    kernels evaluate the same float32 operations in the same order
    (``sample_pos`` in ``csrc/rotated_sampler.cu``), so all versions
    agree bit for bit on the positions and on which taps are ties.
    """
    u = _positions(int(out_size.width), theta.device)
    v = _positions(int(out_size.height), theta.device)[:, None]
    t = theta.float()[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    px = (t[:, 0, 0] * u + t[:, 0, 1] * v + t[:, 0, 2] + 1.0) * (0.5 * (w - 1))
    py = (t[:, 1, 0] * u + t[:, 1, 1] * v + t[:, 1, 2] + 1.0) * (0.5 * (h - 1))
    return px, py


class _Tap(NamedTuple):
    index: torch.Tensor  # pixel index along the axis, 0 where outside
    hat: torch.Tensor  # hat(p - pixel), 0 where outside
    hat_grad: torch.Tensor  # _hat_grad_dense(p - pixel), 0 where outside


def _axis_taps(p: torch.Tensor, size: int) -> tuple[_Tap, _Tap]:
    """The two taps floor(p) and floor(p) + 1 of positions ``p`` along an
    axis of ``size`` pixels: every pixel whose hat or hat' is non-zero.
    A tap outside the image, or of a position that is not finite, has
    zero weights (zero padding)."""
    first = torch.floor(p)
    taps = []
    for k in (0.0, 1.0):
        pixel = first + k
        inside = (pixel >= 0) & (pixel <= size - 1)
        d = p - pixel
        taps.append(_Tap(
            torch.where(inside, pixel, 0.0).long(),
            torch.where(inside, _hat(d), 0.0),
            torch.where(inside, _hat_grad_dense(d), 0.0),
        ))
    return taps[0], taps[1]


def _gather_tap(flat: torch.Tensor, ty: _Tap, tx: _Tap, w: int) -> torch.Tensor:
    """img[ty, tx] for every output position: (N, H_out, W_out, C)."""
    n, _, c = flat.shape
    idx = (ty.index * w + tx.index).reshape(n, -1, 1).expand(-1, -1, c)
    return torch.gather(flat, 1, idx).reshape(ty.index.shape + (c,))


def _rotated_plain(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    n, h, w, c = images.shape
    px, py = _rotated_positions(theta, out_size, h, w)
    xs, ys = _axis_taps(px, w), _axis_taps(py, h)
    flat = images.float().reshape(n, h * w, c)
    # Sum over the columns of each row tap, then over the rows, as the
    # kernel does.
    rows = [
        xs[0].hat[..., None] * _gather_tap(flat, ty, xs[0], w)
        + xs[1].hat[..., None] * _gather_tap(flat, ty, xs[1], w)
        for ty in ys
    ]
    out = ys[0].hat[..., None] * rows[0] + ys[1].hat[..., None] * rows[1]
    nan = (torch.isnan(px) | torch.isnan(py))[..., None]
    return torch.where(nan, float("nan"), out).to(images.dtype)


def sample_rotated_bwd(
    images: torch.Tensor,
    theta: torch.Tensor,
    g: torch.Tensor,
    out_size: Size,
    need_images: bool = True,
    need_theta: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Plain analytic VJP of ``sample_rotated`` — the plain version of the
    backward kernels, following JAX's ``_rotated_dense_bwd_impl``.

    With hat' from ``_hat_grad_dense`` (0 at a tie, unlike the separable
    crop's ``_hat_grad``):
      * gpx[i, j] = (W−1)/2 · Σ_c g · Σ_y hat(py−y) Σ_x hat'(px−x) img,
        gpy alike with hat'(py−y) hat(px−x) and (H−1)/2;
      * dθ row 0 = [Σ gpx·u_j, Σ gpx·v_i, Σ gpx], row 1 the same with gpy:
        all six entries;
      * d img[y, x] = Σ_{i,j} hat(py−y) · hat(px−x) · g[i, j], taps
        outside the image dropped.

    NaN positions give what the dense product gives: gpx is NaN where py
    is (and 0 where only px is), gpy where px is, and the d images of an
    image with any NaN position are NaN throughout.

    Args:
      images: (N, H, W, C); theta: (N, 2, 3); g: (N, H_out, W_out, C), the
        cotangent of the crop.
      out_size: crop size.
      need_images, need_theta: which gradients to compute.

    Returns:
      (d images in the images' dtype or None, d theta in theta's dtype or
      None).
    """
    n, h, w, c = images.shape
    px, py = _rotated_positions(theta, out_size, h, w)
    xs, ys = _axis_taps(px, w), _axis_taps(py, h)
    g = g.float()
    d_images = d_theta = None
    if need_theta:
        flat = images.float().reshape(n, h * w, c)
        sx = sy = 0.0  # Σ_y hat Σ_x hat' img and Σ_y hat' Σ_x hat img
        for ty in ys:
            v0, v1 = (_gather_tap(flat, ty, tx, w) for tx in xs)
            row = xs[0].hat[..., None] * v0 + xs[1].hat[..., None] * v1
            drow = xs[0].hat_grad[..., None] * v0 + xs[1].hat_grad[..., None] * v1
            sx = sx + ty.hat[..., None] * drow
            sy = sy + ty.hat_grad[..., None] * row
        gpx = (g * sx).sum(-1) * (0.5 * (w - 1))  # (N, H_out, W_out)
        gpy = (g * sy).sum(-1) * (0.5 * (h - 1))
        gpx = torch.where(torch.isnan(py), float("nan"), gpx)
        gpy = torch.where(torch.isnan(px), float("nan"), gpy)
        u = _positions(int(out_size.width), theta.device)
        v = _positions(int(out_size.height), theta.device)[:, None]
        d_theta = torch.stack([
            torch.stack([(gp * u).sum((1, 2)), (gp * v).sum((1, 2)), gp.sum((1, 2))], dim=1)
            for gp in (gpx, gpy)
        ], dim=1).to(theta.dtype)
    if need_images:
        d = torch.zeros((n, h * w, c), dtype=torch.float32, device=g.device)
        for ty in ys:
            a = ty.hat[..., None] * g
            for tx in xs:
                idx = (ty.index * w + tx.index).reshape(n, -1, 1).expand(-1, -1, c)
                d.scatter_add_(1, idx, (a * tx.hat[..., None]).reshape(n, -1, c))
        nan = (torch.isnan(px) | torch.isnan(py)).flatten(1).any(1)
        d[nan] = float("nan")
        d_images = d.reshape(n, h, w, c).to(images.dtype)
    return d_images, d_theta


# -- CUDA kernel wrappers ---------------------------------------------------
def _check_cuda_float32(what: str, **tensors: torch.Tensor) -> None:
    devices = {t.device for t in tensors.values()}
    if not all(t.is_cuda for t in tensors.values()):
        raise ValueError(
            f"{what} runs on CUDA tensors only; use the plain version "
            "for tensors on the CPU"
        )
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check_theta(theta: torch.Tensor, n: int) -> None:
    if tuple(theta.shape) != (n, 2, 3):
        raise ValueError(f"theta must be ({n}, 2, 3), got {tuple(theta.shape)}")


def _check_crop_inputs(what: str, images: torch.Tensor, theta: torch.Tensor) -> None:
    _check_cuda_float32(what, images=images, theta=theta)
    if images.dim() != 4:
        raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
    _check_theta(theta, images.shape[0])


def _check_offsets(what: str, image: tuple[int, int, int], crop: tuple[int, int, int]) -> None:
    (h, w, c), (h_out, w_out, _) = image, crop
    if max(h * w * c, h_out * w_out * c) > _MAX_IMAGE_ELEMENTS:
        raise ValueError(f"{what}: an image {h}x{w}x{c} or crop {h_out}x{w_out}x{c} is too large "
                         "for the kernel's 32-bit offsets")


def _launch(library: str, entry: str, owner: Callable, counter: str, *args) -> None:
    """Launch ``entry`` of ``csrc/<library>.cu`` on the current stream,
    raise on a CUDA error, then add one to ``owner.<counter>``."""
    lib = _cuda.load_library(library)
    err = getattr(lib, entry)(*args)
    _cuda.check(lib, err, entry)
    setattr(owner, counter, getattr(owner, counter) + 1)


def _crop_kernel(
    library: str, owner: Callable, images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """The forward kernel ``<library>_fwd``, one launch; counts in
    ``owner.launches``."""
    n, h, w, c = images.shape
    h_out, w_out = int(out_size.height), int(out_size.width)
    out = torch.empty((n, h_out, w_out, c), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    _check_offsets(f"{library}_fwd", (h, w, c), (h_out, w_out, c))
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _launch(
        library, f"{library}_fwd", owner, "launches",
        images.data_ptr(), theta.data_ptr(), out.data_ptr(),
        n, h, w, c, h_out, w_out, images.device.index, stream,
    )
    return out


def _bwd_theta_kernel(
    library: str, owner: Callable, images: torch.Tensor, theta: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """The d theta kernel ``<library>_bwd_theta``, one launch that writes
    all six entries; counts in ``owner.launches_bwd_theta``."""
    what = f"{library}_bwd_theta"
    g = g.contiguous()
    _check_cuda_float32(what, images=images, theta=theta, g=g)
    if images.dim() != 4 or g.dim() != 4:
        raise ValueError(f"images and g must be 4-D, got {tuple(images.shape)} and {tuple(g.shape)}")
    n, h, w, c = images.shape
    _check_theta(theta, n)
    if g.shape[0] != n or g.shape[3] != c:
        raise ValueError(f"g must be ({n}, H_out, W_out, {c}), got {tuple(g.shape)}")
    h_out, w_out = g.shape[1], g.shape[2]
    if g.numel() == 0 or images.numel() == 0:
        return torch.zeros((n, 2, 3), dtype=torch.float32, device=images.device)
    _check_offsets(what, (h, w, c), (h_out, w_out, c))
    d_theta = torch.empty((n, 2, 3), dtype=torch.float32, device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _launch(
        library, what, owner, "launches_bwd_theta",
        images.data_ptr(), theta.data_ptr(), g.data_ptr(), d_theta.data_ptr(),
        n, h, w, c, h_out, w_out, images.device.index, stream,
    )
    return d_theta


def _bwd_images_kernel(
    library: str, owner: Callable,
    theta: torch.Tensor, g: torch.Tensor, image_shape: tuple[int, int, int, int],
) -> torch.Tensor:
    """The d images kernel ``<library>_bwd_images``, one launch that writes
    every element; counts in ``owner.launches_bwd_images``."""
    what = f"{library}_bwd_images"
    g = g.contiguous()
    _check_cuda_float32(what, theta=theta, g=g)
    n, h, w, c = (int(s) for s in image_shape)
    _check_theta(theta, n)
    if g.dim() != 4 or g.shape[0] != n or g.shape[3] != c:
        raise ValueError(f"g must be ({n}, H_out, W_out, {c}), got {tuple(g.shape)}")
    h_out, w_out = g.shape[1], g.shape[2]
    d_images = torch.empty((n, h, w, c), dtype=torch.float32, device=g.device)
    if d_images.numel() == 0 or g.numel() == 0:
        return d_images.zero_()
    _check_offsets(what, (h, w, c), (h_out, w_out, c))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _launch(
        library, what, owner, "launches_bwd_images",
        theta.data_ptr(), g.data_ptr(), d_images.data_ptr(),
        n, h, w, c, h_out, w_out, g.device.index, stream,
    )
    return d_images


def separable_sampler_bwd_theta(
    images: torch.Tensor, theta: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """d theta of the crop as the CUDA kernel ``separable_sampler_bwd_theta``
    — the kernel of ``sample_separable_bwd(..., need_images=False)``.

    Takes CUDA float32 tensors on one device: contiguous ``images``
    (N, H, W, C) and ``theta`` (N, 2, 3), and the cotangent ``g``
    (N, H_out, W_out, C), made contiguous here. Launches on the current
    stream; each launch adds one to
    ``sample_separable_kernel.launches_bwd_theta``.

    Returns:
      (N, 2, 3) float32 d theta (zero off-diagonals). Deterministic.
    """
    return _bwd_theta_kernel("separable_sampler", sample_separable_kernel, images, theta, g)


def separable_sampler_bwd_images(
    theta: torch.Tensor, g: torch.Tensor, image_shape: tuple[int, int, int, int]
) -> torch.Tensor:
    """d images of the crop as the CUDA kernel
    ``separable_sampler_bwd_images`` (kyᵀ · g · kx, gathered: each element
    sums, in a fixed order, the outputs whose hat reaches it) — the kernel
    of ``sample_separable_bwd(..., need_theta=False)``.

    Takes CUDA float32 tensors on one device: contiguous ``theta``
    (N, 2, 3) and the cotangent ``g`` (N, H_out, W_out, C), made
    contiguous here. Launches on the current stream; each launch adds one
    to ``sample_separable_kernel.launches_bwd_images``.

    Returns:
      float32 d images of ``image_shape`` (N, H, W, C), one launch.
      Deterministic.
    """
    return _bwd_images_kernel("separable_sampler", sample_separable_kernel, theta, g, image_shape)


def rotated_sampler_bwd_theta(
    images: torch.Tensor, theta: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """d theta of the rotated crop as the CUDA kernel
    ``rotated_sampler_bwd_theta`` — the kernel of
    ``sample_rotated_bwd(..., need_images=False)``, with its subgradients.

    Takes CUDA float32 tensors on one device: contiguous ``images``
    (N, H, W, C) and ``theta`` (N, 2, 3), and the cotangent ``g``
    (N, H_out, W_out, C), made contiguous here. Launches on the current
    stream; each launch adds one to
    ``sample_rotated_kernel.launches_bwd_theta``.

    Returns:
      (N, 2, 3) float32 d theta, all six entries. Deterministic.
    """
    return _bwd_theta_kernel("rotated_sampler", sample_rotated_kernel, images, theta, g)


def rotated_sampler_bwd_images(
    theta: torch.Tensor, g: torch.Tensor, image_shape: tuple[int, int, int, int]
) -> torch.Tensor:
    """d images of the rotated crop as the CUDA kernel
    ``rotated_sampler_bwd_images`` (per tile of pixels, the outputs whose
    taps reach it, found through the inverse of theta's linear part, added
    in a fixed order) — the kernel of
    ``sample_rotated_bwd(..., need_theta=False)``.

    Takes CUDA float32 tensors on one device: contiguous ``theta``
    (N, 2, 3) and the cotangent ``g`` (N, H_out, W_out, C), made
    contiguous here. Launches on the current stream; each launch adds one
    to ``sample_rotated_kernel.launches_bwd_images``.

    Returns:
      float32 d images of ``image_shape`` (N, H, W, C), one launch.
      Deterministic.
    """
    return _bwd_images_kernel("rotated_sampler", sample_rotated_kernel, theta, g, image_shape)


# -- autograd Functions -------------------------------------------------------
class _Versions(NamedTuple):
    """One crop's plain version and kernels."""

    name: str
    plain: Callable
    plain_bwd: Callable
    kernel: Callable  # (images, theta, out_size) -> crop
    bwd_theta: Callable
    bwd_images: Callable
    kernel_name: str


def _crop_forward(ctx, versions: _Versions, images, theta, out_size, backend):
    ctx.save_for_backward(images, theta)
    ctx.out_size = Size(*out_size)
    ctx.backend = backend
    ctx.versions = versions
    if backend == "cuda":
        return versions.kernel(images, theta, ctx.out_size)
    return versions.plain(images, theta, ctx.out_size)


def _crop_backward(ctx, g):
    images, theta = ctx.saved_tensors
    need_images, need_theta = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
    versions = ctx.versions
    if ctx.backend == "cuda":
        d_images = d_theta = None
        if need_theta:
            d_theta = versions.bwd_theta(images, theta, g)
        if need_images:
            d_images = versions.bwd_images(theta, g, tuple(images.shape))
        return d_images, d_theta, None, None
    if g.is_cuda:
        raise ValueError(
            f"the plain {versions.name} backward takes CPU tensors only; "
            f"crop CUDA tensors with {versions.kernel_name}"
        )
    d_images, d_theta = versions.plain_bwd(
        images, theta, g, ctx.out_size, need_images, need_theta
    )
    return d_images, d_theta, None, None


class SeparableSampler(torch.autograd.Function):
    """The separable crop with an analytic backward.

    ``backend="plain"`` runs ``_separable_plain`` forward and
    ``sample_separable_bwd`` backward; ``backend="cuda"`` runs the CUDA
    kernels. d images is computed only when the images need it (never on
    the training path, whose images are data). The plain backward takes
    CPU tensors only: a CUDA tensor reaches the kernels or raises.
    """

    @staticmethod
    def forward(ctx, images, theta, out_size, backend):
        return _crop_forward(ctx, _SEPARABLE, images, theta, out_size, backend)

    @staticmethod
    def backward(ctx, g):
        return _crop_backward(ctx, g)


class RotatedSampler(torch.autograd.Function):
    """The rotated (general-affine) crop with an analytic backward.

    ``backend="plain"`` runs ``_rotated_plain`` forward and
    ``sample_rotated_bwd`` backward; ``backend="cuda"`` runs the CUDA
    kernels of ``csrc/rotated_sampler.cu``. As ``SeparableSampler``: d
    images only when the images need it, and the plain backward takes CPU
    tensors only.
    """

    @staticmethod
    def forward(ctx, images, theta, out_size, backend):
        return _crop_forward(ctx, _ROTATED, images, theta, out_size, backend)

    @staticmethod
    def backward(ctx, g):
        return _crop_backward(ctx, g)


def sample_separable(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """Axis-aligned affine crop as two batched float32 matmuls — the plain
    version of the CUDA kernel ``sample_separable_kernel``, differentiable
    through ``sample_separable_bwd`` (CPU tensors).

    Requires theta off-diagonals to be zero (guaranteed by
    ``rotation_dropout(ratio=0.0)``); ignores them if nonzero. On the card
    the matmuls run in full float32 only with
    ``torch.backends.cuda.matmul.allow_tf32`` off.

    Args:
      images: (N, H, W, C).
      theta: (N, 2, 3); uses theta[:, 0, 0] (x scale), theta[:, 0, 2]
        (x shift), theta[:, 1, 1] (y scale), theta[:, 1, 2] (y shift).
      out_size: crop size.

    Returns:
      (N, H_out, W_out, C) crops in the images' dtype.
    """
    return SeparableSampler.apply(images, theta, out_size, "plain")


def sample_separable_kernel(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """``sample_separable`` as the CUDA kernel ``separable_sampler_fwd``,
    differentiable through the backward kernels.

    Takes CUDA tensors only: float32 NHWC ``images`` (N, H, W, C) and
    float32 ``theta`` (N, 2, 3), both contiguous, on one device. Launches
    on the current stream; each forward launch adds one to
    ``sample_separable_kernel.launches``, each backward launch to
    ``.launches_bwd_theta`` or ``.launches_bwd_images``.

    Returns:
      (N, H_out, W_out, C) float32 crops.
    """
    _check_crop_inputs("sample_separable_kernel", images, theta)
    return SeparableSampler.apply(images, theta, out_size, "cuda")


sample_separable_kernel.launches = 0
sample_separable_kernel.launches_bwd_theta = 0
sample_separable_kernel.launches_bwd_images = 0


def sample_rotated(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """General-affine bilinear crop as a 4-tap gather — the plain version
    of the CUDA kernel ``sample_rotated_kernel``, differentiable through
    ``sample_rotated_bwd`` (CPU tensors).

    Samples output (i, j) at the positions of ``_rotated_positions``: the
    same function as ``sample_grid(images, affine_grid(theta))`` and as the
    JAX package's ``sample_rotated_dense`` / ``sample_rotated_pallas``,
    zero padding included. A NaN position gives a NaN output there.

    Args:
      images: (N, H, W, C).
      theta: (N, 2, 3), all six entries used.
      out_size: crop size.

    Returns:
      (N, H_out, W_out, C) contiguous crops in the images' dtype, summed
      in float32.
    """
    return RotatedSampler.apply(images, theta, out_size, "plain")


def sample_rotated_kernel(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """``sample_rotated`` as the CUDA kernel ``rotated_sampler_fwd``,
    differentiable through the backward kernels
    (``rotated_sampler_bwd_theta``, ``rotated_sampler_bwd_images``).

    Takes CUDA tensors only: float32 NHWC ``images`` (N, H, W, C) and
    float32 ``theta`` (N, 2, 3), both contiguous, on one device. Launches
    on the current stream; each forward launch adds one to
    ``sample_rotated_kernel.launches``, each backward launch to
    ``.launches_bwd_theta`` or ``.launches_bwd_images``.

    Returns:
      (N, H_out, W_out, C) float32 crops.
    """
    _check_crop_inputs("sample_rotated_kernel", images, theta)
    return RotatedSampler.apply(images, theta, out_size, "cuda")


sample_rotated_kernel.launches = 0
sample_rotated_kernel.launches_bwd_theta = 0
sample_rotated_kernel.launches_bwd_images = 0

_SEPARABLE = _Versions(
    "separable", _separable_plain, sample_separable_bwd,
    functools.partial(_crop_kernel, "separable_sampler", sample_separable_kernel),
    separable_sampler_bwd_theta, separable_sampler_bwd_images,
    "sample_separable_kernel (method='pallas')",
)
_ROTATED = _Versions(
    "rotated", _rotated_plain, sample_rotated_bwd,
    functools.partial(_crop_kernel, "rotated_sampler", sample_rotated_kernel),
    rotated_sampler_bwd_theta, rotated_sampler_bwd_images,
    "sample_rotated_kernel (method='rotated_pallas')",
)


def spatial_transform(
    images: torch.Tensor,
    theta: torch.Tensor,
    out_size: Size,
    method: str = "separable",
) -> torch.Tensor:
    """Crop ``images`` with affine params ``theta``.

    Args:
      images: (N, H, W, C).
      theta: (N, 2, 3).
      out_size: crop size.
      method: 'separable' (plain two-matmul version; axis-aligned theta),
        'pallas' (the CUDA kernels of the same function; CUDA tensors
        only), 'rotated' (plain 4-tap gather; any theta), 'rotated_pallas'
        (the CUDA kernels of the same function; CUDA tensors only), or
        'general' (gather-based reference; any theta).

    Returns:
      (N, H_out, W_out, C) crops.
    """
    if method == "separable":
        return sample_separable(images, theta, out_size)
    if method == "pallas":
        return sample_separable_kernel(images, theta, out_size)
    if method == "rotated":
        return sample_rotated(images, theta, out_size)
    if method == "rotated_pallas":
        return sample_rotated_kernel(images, theta, out_size)
    if method == "general":
        return sample_grid(images, affine_grid(theta, out_size))
    raise ValueError(f"unknown spatial_transform method: {method!r}")
