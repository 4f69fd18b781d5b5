"""Spatial transformer: affine grid generation + bilinear crop (port of
``loans_tpu/ops/stn.py``).

Three implementations of one function, with the JAX package's names:

1. ``sample_grid`` over ``affine_grid`` — general gather-based bilinear
   sampling of a materialized grid, any affine theta. The correctness
   reference and ``method="general"``.
2. ``sample_separable`` — the plain PyTorch version of the axis-aligned
   crop: hat-weight matrices built in float32, then two batched matmuls
   in float32. ``method="separable"``.
3. ``sample_separable_kernel`` — the same function as a hand-written CUDA
   kernel (``csrc/separable_sampler.cu``), replacing the Pallas kernel
   ``loans_tpu/ops/stn.py::_separable_kernel``. ``method="pallas"``.
   Forward only: the backward kernels come with the training path, so the
   wrapper refuses tensors that require grad.

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


def _positions(out_dim: int, device) -> torch.Tensor:
    """Normalized output positions u_i = -1 + step * i, float32.

    ``step`` is 0 for a single output (u = -1, as ``linspace(-1, 1, 1)``
    gives). The CUDA kernel evaluates the same expression in the same
    order, so both versions sample at bit-identical positions.
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


def _interp_weights(
    scale: torch.Tensor, shift: torch.Tensor, out_dim: int, in_dim: int
) -> torch.Tensor:
    """Bilinear interpolation matrix for one separable axis, float32.

    Output position i samples input pixel
    p_i = (scale * u_i + shift + 1) * (in - 1) / 2; the weight on input
    index j is the hat max(0, 1 - |p_i - j|), which reproduces zero
    padding outside the image.

    Args:
      scale, shift: (N,) per-sample affine scale/translation for this axis.
      out_dim, in_dim: sizes.

    Returns:
      (N, out_dim, in_dim) float32 weight matrices.
    """
    u = _positions(out_dim, scale.device)
    p = (
        scale.float()[:, None] * u[None, :] + shift.float()[:, None] + 1.0
    ) * (0.5 * (in_dim - 1))
    j = torch.arange(in_dim, dtype=torch.float32, device=scale.device)
    return (1.0 - (p[:, :, None] - j).abs()).clamp(min=0.0)


def sample_separable(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """Axis-aligned affine crop as two batched float32 matmuls — the plain
    version of the CUDA kernel ``sample_separable_kernel``.

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
    n, h, w, c = images.shape
    h_out, w_out = int(out_size.height), int(out_size.width)
    ky = _interp_weights(theta[:, 1, 1], theta[:, 1, 2], h_out, h)
    kx = _interp_weights(theta[:, 0, 0], theta[:, 0, 2], w_out, w)
    # Contract input rows, then input columns.
    tmp = torch.bmm(ky, images.float().reshape(n, h, w * c))
    tmp = tmp.reshape(n, h_out, w, c)
    out = torch.einsum("nwq,nhqc->nhwc", kx, tmp)
    return out.to(images.dtype)


def sample_separable_kernel(
    images: torch.Tensor, theta: torch.Tensor, out_size: Size
) -> torch.Tensor:
    """``sample_separable`` as the CUDA kernel ``separable_sampler_fwd``.

    Takes CUDA tensors only: float32 NHWC ``images`` (N, H, W, C) and
    float32 ``theta`` (N, 2, 3), both contiguous, on one device, neither
    requiring grad. Launches on the current stream; each launch adds one
    to ``sample_separable_kernel.launches``.

    Returns:
      (N, H_out, W_out, C) float32 crops.
    """
    if not (images.is_cuda and theta.is_cuda):
        raise ValueError(
            "sample_separable_kernel runs on CUDA tensors only; use "
            "sample_separable for tensors on the CPU"
        )
    if images.device != theta.device:
        raise ValueError(
            f"images on {images.device} but theta on {theta.device}"
        )
    if images.dtype != torch.float32 or theta.dtype != torch.float32:
        raise TypeError(
            "sample_separable_kernel takes float32 images and theta, got "
            f"{images.dtype} and {theta.dtype}"
        )
    if images.dim() != 4:
        raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
    n, h, w, c = images.shape
    if tuple(theta.shape) != (n, 2, 3):
        raise ValueError(
            f"theta must be ({n}, 2, 3), got {tuple(theta.shape)}"
        )
    if not (images.is_contiguous() and theta.is_contiguous()):
        raise ValueError("images and theta must be contiguous")
    if torch.is_grad_enabled() and (images.requires_grad or theta.requires_grad):
        raise NotImplementedError(
            "sample_separable_kernel has no backward kernel yet; run it "
            "under torch.inference_mode() or torch.no_grad()"
        )
    h_out, w_out = int(out_size.height), int(out_size.width)
    out = torch.empty(
        (n, h_out, w_out, c), dtype=torch.float32, device=images.device
    )
    if out.numel() == 0:
        return out
    lib = _cuda.load_library("separable_sampler")
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = lib.separable_sampler_fwd(
        images.data_ptr(), theta.data_ptr(), out.data_ptr(),
        n, h, w, c, h_out, w_out, images.device.index, stream,
    )
    _cuda.check(lib, err, "separable_sampler_fwd")
    sample_separable_kernel.launches += 1
    return out


sample_separable_kernel.launches = 0


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
        'pallas' (the CUDA kernel of the same function; CUDA tensors
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
