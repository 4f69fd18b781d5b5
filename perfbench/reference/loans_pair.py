"""The LoANs localizer/assessor pair (``Bartzi/loans``: the
``Resnet50SheepLocalizer`` of ``sheep/sheep_localizer.py:120-178``, the
``ResnetAssessor`` of ``common/net.py:70-90``) in plain float32 PyTorch:
its alternating training step with two AMSGrad optimisers, and its served
forward with the assessor's gate.

* Localizer: x * 255 - ImageNet mean, ResNet-50, global average pooling,
  a linear head to the (2, 3) affine theta; rotation dropout at ratio 0
  zeroes theta's off-diagonals; the crop samples the (unnormalised) image
  bilinearly at theta's grid, align-corners, zero outside the image.
* Localizer loss: mean((assessor(crops) - 1)^2), the assessor's
  parameters held fixed, + the direction loss (mean of relu(tl_y - bl_y)
  and of relu(tl_x - tr_x) on pixel corners) + the out-of-image loss (sum
  over tl_x, tl_y, tr_x, bl_y of |min(v + 1, 0)| + max(v - 1, 0)).
* Assessor loss: mean((assessor(real crops) - IoU labels)^2).
* AMSGrad by optax's rule: the maximum of the bias-corrected second
  moment; chainer's lr 1e-3, betas (0.9, 0.999), eps 1e-8.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from perfbench.reference.assessor import Assessor
from perfbench.reference.resnet import BatchNorm, ResNet50

IMAGENET_MEAN_RGB = (123.68, 116.779, 103.939)
HEAD_BIAS = (0.8, 0.0, 0.0, 0.0, 0.8, 0.0)
OFFDIAG_ZERO = ((1.0, 0.0, 1.0), (0.0, 1.0, 1.0))
CORNERS_XY = ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0))  # tl, tr, bl, br
LR, BETAS, EPS = 1e-3, (0.9, 0.999), 1e-8


class Localizer(nn.Module):
    def __init__(self, input_size: tuple[int, int], out_size: tuple[int, int]):
        super().__init__()
        self.input_size, self.out_size = tuple(input_size), tuple(out_size)
        self.feature_extractor = ResNet50()
        self.param_predictor = nn.Linear(self.feature_extractor.feature_dim, 6)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN_RGB), persistent=False)

    def theta(self, images: torch.Tensor) -> torch.Tensor:
        x = (images * 255.0 - self.mean).permute(0, 3, 1, 2)
        h = self.feature_extractor(x).mean(dim=(2, 3))
        theta = self.param_predictor(h).reshape(-1, 2, 3)
        return theta * theta.new_tensor(OFFDIAG_ZERO)


def _hat(d: torch.Tensor) -> torch.Tensor:
    """The bilinear tap weight max(0, 1 - |d|) of a pixel at distance d,
    differentiated as the configuration states it: as automatic
    differentiation of that expression, |d|' = +1 at d = 0 and the
    maximum's gradient halved where it ties with 0 (|d| = 1)."""
    a = torch.where(d >= 0, d, -d)
    return torch.maximum(1.0 - a, torch.zeros((), dtype=d.dtype, device=d.device))


def crop(images: torch.Tensor, theta: torch.Tensor, out_size: tuple[int, int], columns_first: bool = False) -> torch.Tensor:
    """Bilinear sampling of NHWC ``images`` at the axis-aligned grid of
    ``theta`` (its diagonal and shifts): output (i, j) at pixel
    ((theta_00 u_j + theta_02 + 1) (W - 1) / 2, (theta_11 u_i + theta_12 +
    1) (H - 1) / 2), u spaced evenly over [-1, 1] (align corners); pixels
    outside the image read 0. Written as tap-weight matrices over rows and
    columns, contracted rows first (``columns_first``: the other order, a
    second float32 witness that rounds differently); differentiable in
    ``theta``."""
    n, h, w, c = images.shape
    ho, wo = out_size

    def taps(scale, shift, out_dim, in_dim):
        u = -1.0 + (2.0 / (out_dim - 1)) * torch.arange(out_dim, dtype=torch.float32, device=theta.device)
        p = (scale[:, None] * u[None, :] + shift[:, None] + 1.0) * (0.5 * (in_dim - 1))
        return _hat(p[:, :, None] - torch.arange(in_dim, dtype=torch.float32, device=theta.device))

    ky = taps(theta[:, 1, 1], theta[:, 1, 2], ho, h)  # (N, ho, H)
    kx = taps(theta[:, 0, 0], theta[:, 0, 2], wo, w)  # (N, wo, W)
    if columns_first:
        cols = torch.einsum("njx,nyxc->nyjc", kx, images)
        return torch.einsum("niy,nyjc->nijc", ky, cols)
    rows = torch.bmm(ky, images.reshape(n, h, w * c)).reshape(n, ho, w, c)
    return torch.einsum("njx,nixc->nijc", kx, rows)


def corners(theta: torch.Tensor) -> torch.Tensor:
    """(N, 4, 2) normalised (x, y) corners tl, tr, bl, br of theta's region."""
    return torch.stack([theta[:, :, 0] * cx + theta[:, :, 1] * cy + theta[:, :, 2] for cx, cy in CORNERS_XY], 1)


def pixel_corners(c: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    return (c + 1.0) / 2.0 * c.new_tensor([size[1], size[0]])


def boxes(theta: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(N, 4) (y_min, x_min, y_max, x_max) pixel box around theta's
    corners, clipped to the image."""
    px = pixel_corners(corners(theta), size)
    px = torch.minimum(px.clamp(min=0.0), px.new_tensor([size[1], size[0]]))
    tl, tr, bl, br = px.unbind(1)
    return torch.stack([torch.minimum(tl[:, 1], tr[:, 1]), torch.minimum(tl[:, 0], bl[:, 0]),
                        torch.maximum(bl[:, 1], br[:, 1]), torch.maximum(tr[:, 0], br[:, 0])], 1)


def regularisers(theta: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    c = corners(theta)
    px = pixel_corners(c, size)
    direction = F.relu(px[:, 0, 1] - px[:, 2, 1]).mean() + F.relu(px[:, 0, 0] - px[:, 1, 0]).mean()
    v = torch.cat([c[:, 0, 0], c[:, 0, 1], c[:, 1, 0], c[:, 2, 1]])
    return direction + (-torch.clamp(v + 1.0, max=0.0)).sum() + F.relu(v - 1.0).sum()


class AMSGrad:
    """optax.amsgrad over a list of parameters, updated in place."""

    def __init__(self, params):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = BETAS
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g * g, alpha=1 - b2)
            torch.maximum(nu_max, nu / (1 - b2 ** self.t), out=nu_max)
            p.sub_(LR * (mu / (1 - b1 ** self.t)) / (nu_max.sqrt() + EPS))

    def norms(self, names) -> dict[str, dict[str, float]]:
        """The norm of each leaf's mu and nu_max, by the leaves' ``names``."""
        return {"mu": leaf_norms(dict(zip(names, self.mu))), "nu_max": leaf_norms(dict(zip(names, self.nu_max)))}


def build(config: dict, device, weights: dict | None = None) -> tuple[Localizer, Assessor]:
    loc_cfg, ass_cfg = config["localizer"], config["assessor"]
    with torch.device(device):
        loc = Localizer(loc_cfg["input_size"], loc_cfg["out_size"])
        ass = Assessor(ass_cfg["ch"], loc_cfg["out_size"])
    if weights is not None:
        loc.load_state_dict(strict_part(weights, "localizer."))
        ass.load_state_dict(strict_part(weights, "assessor."))
    return loc, ass


def strict_part(weights: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


def weight_spec(config: dict) -> list[tuple[str, tuple, tuple]]:
    """``[(name, shape, rule)]`` of the pair's state dict, names prefixed
    ``localizer.`` and ``assessor.``: convolutions He-normal
    (std sqrt(2 / fan_in)), the localizer's head normal with the
    configuration's assumed std and its published bias (a centred 0.8-scale
    crop), the assessor's head normal with its assumed std, BatchNorm at
    its initial values (scale 1, shift 0, statistics 0 and 1)."""
    assumed = config["assumed"]
    loc, ass = build(config, "meta")
    spec = []
    for prefix, model in (("localizer.", loc), ("assessor.", ass)):
        for name, t in model.state_dict().items():
            shape = tuple(t.shape)
            if name == "param_predictor.weight":
                rule = ("normal", assumed["localizer_head_std"])
            elif name == "param_predictor.bias":
                rule = ("const", HEAD_BIAS)
            elif name == "Dense_0.weight":
                rule = ("normal", assumed["assessor_head_std"])
            elif len(shape) == 4:
                rule = ("normal", math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))
            elif name.endswith(("weight", "running_var")):
                rule = ("const", 1.0)
            else:
                rule = ("const", 0.0)
            spec.append((prefix + name, shape, rule))
    return spec


@torch.no_grad()
def calibrate(config: dict, weights: dict, frames: torch.Tensor) -> dict:
    """``weights`` with BatchNorm statistics as a training run leaves them:
    each BatchNorm's running mean and (biased) variance set to its input's
    batch statistics in a training-mode forward over ``frames``. Without
    them a network of random weights grows its activations through 50
    layers in evaluation mode."""
    loc, _ = build(config, frames.device, weights)
    loc.train()
    stats = {}

    def keep(name):
        def hook(module, args):
            x = args[0]
            stats[name + ".running_mean"] = x.mean(dim=(0, 2, 3))
            stats[name + ".running_var"] = x.var(dim=(0, 2, 3), unbiased=False)
        return hook

    handles = [m.register_forward_pre_hook(keep("localizer." + n))
               for n, m in loc.named_modules() if isinstance(m, BatchNorm)]
    try:
        loc.theta(frames)
    finally:
        for h in handles:
            h.remove()
    return {**weights, **stats}


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 with TF32 off (the configuration's), or TF32 on (the
    control's)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def leaf_norms(named: dict[str, torch.Tensor]) -> dict[str, float]:
    norms = torch.stack([v.float().norm() for v in named.values()]).tolist()
    return dict(zip(named, norms))


def train_steps(config: dict, weights: dict, batches, *, half: bool = False, columns_first: bool = False) -> dict:
    """Alternating updates of the pair from ``weights`` over ``batches``
    (``[(scenes uint8 (N, H, W, 3), crops uint8 (N, h, w, 3), labels (N,
    1))]``). Returns each step's (localizer loss, assessor loss), the norm
    of each leaf's first gradient and of each leaf's change after the
    last step, and the norm of each leaf's AMSGrad mu and nu_max after
    each step. ``half`` takes each batch's first half only (a fault);
    ``columns_first`` crops in the other order (a second sound witness)."""
    device = batches[0][0].device
    loc, ass = build(config, device, weights)
    loc.train()
    size = tuple(config["localizer"]["input_size"])
    out = tuple(config["localizer"]["out_size"])
    start = {**{"localizer." + k: v.detach().clone() for k, v in loc.named_parameters()},
             **{"assessor." + k: v.detach().clone() for k, v in ass.named_parameters()}}
    opt_loc, opt_ass = AMSGrad(loc.parameters()), AMSGrad(ass.parameters())
    names_loc = ["localizer." + n for n, _ in loc.named_parameters()]
    names_ass = ["assessor." + n for n, _ in ass.named_parameters()]
    losses, moments, grad1 = [], [], None
    for scenes, crops_u8, labels in batches:
        if half:
            scenes, crops_u8, labels = (t[: len(t) // 2] for t in (scenes, crops_u8, labels))
        unl = scenes.float() * (1.0 / 255.0)
        real = crops_u8.float() * (1.0 / 255.0)
        theta = loc.theta(unl)
        rois = crop(unl, theta, out, columns_first)
        fixed = {k: v.detach() for k, v in ass.named_parameters()}
        y_fake = functional_call(ass, fixed, (rois,))
        loss_loc = torch.mean(torch.square(y_fake - 1.0)) + regularisers(theta, size)
        g_loc = torch.autograd.grad(loss_loc, list(loc.parameters()))
        opt_loc.step(g_loc)
        y_real = ass(real)
        loss_dis = torch.mean(torch.square(y_real - labels))
        g_ass = torch.autograd.grad(loss_dis, list(ass.parameters()))
        opt_ass.step(g_ass)
        losses.append([float(loss_loc.detach()), float(loss_dis.detach())])
        m_loc, m_ass = opt_loc.norms(names_loc), opt_ass.norms(names_ass)
        moments.append({k: {**m_loc[k], **m_ass[k]} for k in m_loc})
        if grad1 is None:
            grad1 = leaf_norms({**{"localizer." + n: g for (n, _), g in zip(loc.named_parameters(), g_loc)},
                                **{"assessor." + n: g for (n, _), g in zip(ass.named_parameters(), g_ass)}})
    now = {**{"localizer." + k: v.detach() for k, v in loc.named_parameters()},
           **{"assessor." + k: v.detach() for k, v in ass.named_parameters()}}
    change = leaf_norms({k: now[k] - start[k] for k in start})
    return {"losses": losses, "grad1": grad1, "change": change, "moments": moments}


@torch.no_grad()
def serve(config: dict, weights: dict, frames: torch.Tensor, block: int = 64) -> dict:
    """The served forward in evaluation mode, in blocks of ``block``
    frames: (N, 4) boxes, (N, h, w, 3) crops and (N,) assessor scores,
    before the gate."""
    loc, ass = build(config, frames.device, weights)
    loc.eval()
    ass.eval()
    size = tuple(config["localizer"]["input_size"])
    out = tuple(config["localizer"]["out_size"])
    parts = {"boxes": [], "rois": [], "scores": []}
    for i in range(0, len(frames), block):
        x = frames[i:i + block]
        theta = loc.theta(x)
        rois = crop(x, theta, out)
        parts["boxes"].append(boxes(theta, size))
        parts["rois"].append(rois)
        parts["scores"].append(ass(rois)[:, 0])
    return {k: torch.cat(v) for k, v in parts.items()}
