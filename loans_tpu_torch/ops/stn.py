"""Spatial transformer: affine grid generation + bilinear crop (port of
``loans_tpu/ops/stn.py``).

Three implementations of one function, with the JAX package's names:

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

Both separable versions are one ``torch.autograd.Function``,
``SeparableSampler``, whose backward is analytic, never autograd through
the hat weights: the plain backward ``sample_separable_bwd`` on the CPU,
and the kernels ``separable_sampler_bwd_theta`` / ``_bwd_images`` on the
card. Its subgradients are JAX's (see ``_hat_grad``).

The dense per-row rotated formulation (``method="rotated"``) and its
Pallas kernel (``method="rotated_pallas"``) are not ported yet.

Coordinate convention (chainer / cuDNN SpatialTf):
  * grid channels are (x, y) in [-1, 1]; (-1, -1) is the top-left corner.
  * pixel mapping is align-corners: px = (x + 1) / 2 * (W - 1).
  * out-of-bounds samples read zeros, with bilinear weights tapering to
    zero over the one-pixel border.
"""

from __future__ import annotations

import torch

from loans_tpu_torch.ops import _cuda
from loans_tpu_torch.ops.geometry import Size

# Scratch of the dtheta kernel: at most this many blocks per image each
# leave 4 partial sums (csrc/separable_sampler.cu, kMaxBlocksPerImage).
_BWD_THETA_MAX_BLOCKS = 32


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
    """d hat / dp at d = p - j, with JAX's subgradients of
    ``maximum(0, 1 - abs(d))``: abs'(0) = +1, so -1 at d = 0; the maximum
    ties with 0 at |d| = 1 and passes half, -0.5 * sign(d); -sign(d)
    inside; 0 beyond. A NaN offset gives NaN."""
    s = torch.where(d >= 0, 1.0, -1.0)
    a = d.abs()
    grad = torch.where(a < 1.0, -s, torch.where(a == 1.0, -0.5 * s, 0.0))
    return torch.where(torch.isnan(d), d, grad)


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


def _launch(name: str, entry: str, *args) -> None:
    lib = _cuda.load_library(name)
    err = getattr(lib, entry)(*args)
    _cuda.check(lib, err, entry)


def _separable_fwd_kernel(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """The forward kernel ``separable_sampler_fwd``; counts in
    ``sample_separable_kernel.launches``."""
    n, h, w, c = images.shape
    h_out, w_out = int(out_size.height), int(out_size.width)
    out = torch.empty((n, h_out, w_out, c), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _launch(
        "separable_sampler", "separable_sampler_fwd",
        images.data_ptr(), theta.data_ptr(), out.data_ptr(),
        n, h, w, c, h_out, w_out, images.device.index, stream,
    )
    sample_separable_kernel.launches += 1
    return out


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
    g = g.contiguous()
    _check_cuda_float32("separable_sampler_bwd_theta", images=images, theta=theta, g=g)
    if images.dim() != 4 or g.dim() != 4:
        raise ValueError(f"images and g must be 4-D, got {tuple(images.shape)} and {tuple(g.shape)}")
    n, h, w, c = images.shape
    _check_theta(theta, n)
    if g.shape[0] != n or g.shape[3] != c:
        raise ValueError(f"g must be ({n}, H_out, W_out, {c}), got {tuple(g.shape)}")
    h_out, w_out = g.shape[1], g.shape[2]
    d_theta = torch.zeros((n, 2, 3), dtype=torch.float32, device=images.device)
    if g.numel() == 0 or images.numel() == 0:
        return d_theta
    partial = torch.empty(
        (n, _BWD_THETA_MAX_BLOCKS, 4), dtype=torch.float32, device=images.device
    )
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _launch(
        "separable_sampler", "separable_sampler_bwd_theta",
        images.data_ptr(), theta.data_ptr(), g.data_ptr(), partial.data_ptr(),
        d_theta.data_ptr(), n, h, w, c, h_out, w_out, images.device.index, stream,
    )
    sample_separable_kernel.launches_bwd_theta += 1
    return d_theta


def separable_sampler_bwd_images(
    theta: torch.Tensor, g: torch.Tensor, image_shape: tuple[int, int, int, int]
) -> torch.Tensor:
    """d images of the crop as the CUDA kernel
    ``separable_sampler_bwd_images`` (kyᵀ · g · kx, scattered with float
    atomics, so the order of its sums changes from run to run) — the
    kernel of ``sample_separable_bwd(..., need_theta=False)``.

    Takes CUDA float32 tensors on one device: contiguous ``theta``
    (N, 2, 3) and the cotangent ``g`` (N, H_out, W_out, C), made
    contiguous here. Launches on the current stream; each launch adds one
    to ``sample_separable_kernel.launches_bwd_images``.

    Returns:
      float32 d images of ``image_shape`` (N, H, W, C).
    """
    g = g.contiguous()
    _check_cuda_float32("separable_sampler_bwd_images", theta=theta, g=g)
    n, h, w, c = (int(s) for s in image_shape)
    _check_theta(theta, n)
    if g.dim() != 4 or g.shape[0] != n or g.shape[3] != c:
        raise ValueError(f"g must be ({n}, H_out, W_out, {c}), got {tuple(g.shape)}")
    h_out, w_out = g.shape[1], g.shape[2]
    d_images = torch.empty((n, h, w, c), dtype=torch.float32, device=g.device)
    if d_images.numel() == 0 or g.numel() == 0:
        return d_images.zero_()
    nan_flags = torch.empty((n,), dtype=torch.int32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _launch(
        "separable_sampler", "separable_sampler_bwd_images",
        theta.data_ptr(), g.data_ptr(), d_images.data_ptr(), nan_flags.data_ptr(),
        n, h, w, c, h_out, w_out, g.device.index, stream,
    )
    sample_separable_kernel.launches_bwd_images += 1
    return d_images


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
        ctx.save_for_backward(images, theta)
        ctx.out_size = Size(*out_size)
        ctx.backend = backend
        if backend == "cuda":
            return _separable_fwd_kernel(images, theta, ctx.out_size)
        return _separable_plain(images, theta, ctx.out_size)

    @staticmethod
    def backward(ctx, g):
        images, theta = ctx.saved_tensors
        need_images, need_theta = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        if ctx.backend == "cuda":
            d_images = d_theta = None
            if need_theta:
                d_theta = separable_sampler_bwd_theta(images, theta, g)
            if need_images:
                d_images = separable_sampler_bwd_images(theta, g, tuple(images.shape))
            return d_images, d_theta, None, None
        if g.is_cuda:
            raise ValueError(
                "the plain separable backward takes CPU tensors only; crop "
                "CUDA tensors with sample_separable_kernel (method='pallas')"
            )
        d_images, d_theta = sample_separable_bwd(
            images, theta, g, ctx.out_size, need_images, need_theta
        )
        return d_images, d_theta, None, None


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
    _check_cuda_float32("sample_separable_kernel", images=images, theta=theta)
    if images.dim() != 4:
        raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
    _check_theta(theta, images.shape[0])
    return SeparableSampler.apply(images, theta, out_size, "cuda")


sample_separable_kernel.launches = 0
sample_separable_kernel.launches_bwd_theta = 0
sample_separable_kernel.launches_bwd_images = 0


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
        only), or 'general' (gather-based reference; any theta).
        'rotated' and 'rotated_pallas' are not ported yet.

    Returns:
      (N, H_out, W_out, C) crops.
    """
    if method == "separable":
        return sample_separable(images, theta, out_size)
    if method == "pallas":
        return sample_separable_kernel(images, theta, out_size)
    if method == "general":
        return sample_grid(images, affine_grid(theta, out_size))
    if method in ("rotated", "rotated_pallas"):
        raise NotImplementedError(
            f"spatial_transform(method={method!r}) is not ported: the "
            "rotated sampler is ROADMAP.md Queue 2 item K2; use "
            "method='general' for rotated theta"
        )
    raise ValueError(f"unknown spatial_transform method: {method!r}")
