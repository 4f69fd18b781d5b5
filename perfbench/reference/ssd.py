"""SSD300 (Liu et al., arXiv:1512.02325) over VGG16, as chainercv builds it
and the LoANs reference trains it (``schaaaafrichter``): its forward, its
default boxes, the training augmentation on the card, the target encoding,
the multibox loss with hard negative mining and the optimiser, in plain
float32 PyTorch.

* Input x * 255 - the VGG mean (RGB). VGG16 to conv5_3 with 3x3
  convolutions (pad 1, bias), 2x2 max pools, pool3 in ceil mode (75 -> 38),
  pool5 3x3 / 1 / pad 1, fc6 3x3 at dilation 6, fc7 1x1; conv4_3 as a
  source after L2 normalisation (eps 1e-12 inside the root, a scale per
  channel, initially 20); extras conv8-conv11 (1x1 then 3x3); a 3x3 loc
  and conf head on each of the six sources, laid out row, column, box.
* Default boxes: chainercv's SSD300 (grids 38..1, steps 8..300, sizes 30..315,
  aspect ratios 2 and 3), (cy, cx, h, w) normalised.
* Augmentation of each image (draws from the step's generator, in the
  order the configuration states them): brightness, contrast and
  saturation jitter; one window, the first of 8 candidates (expanded by a
  ratio in [1, 4) with probability 0.5, scaled by [0.3, 1), of aspect in
  [max(0.5, s^2), min(2, 1/s^2)]) whose least IoU with the boxes meets a
  constraint drawn from {none, 0.1, 0.3, 0.5, 0.7, 0.9}, else the whole
  scene; the window rendered to 300^2 by the bilinear crop with a coverage
  channel (outside the scene: the mean colour); boxes moved into it, kept
  where their centre falls inside, clipped; a horizontal flip with
  probability 0.5.
* Encoding: each default box takes its best box at IoU >= 0.5 and each
  box its best default box; offsets (cy, cx) / (0.1 hw_d), log(hw / hw_d) /
  0.2.
* Loss: smooth L1 over the positives, softmax cross-entropy over the
  positives and the 3 x positives hardest negatives of each image, each
  divided by the batch's positives.
* Optimiser: gradients of biases doubled, weight decay 5e-4 on the rest,
  Adam (lr 1e-4, betas 0.9, 0.999, eps 1e-8).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.loans_pair import crop

VGG_MEAN_RGB = (123.68, 116.779, 103.939)
VGG = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
       (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
EXTRAS = [(1024, 256, 512, 2, 1), (512, 128, 256, 2, 1), (256, 128, 256, 1, 0), (256, 128, 256, 1, 0)]
GRIDS = (38, 19, 10, 5, 3, 1)
STEPS = (8, 16, 32, 64, 100, 300)
SIZES = (30, 60, 111, 162, 213, 264, 315)
RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
SOURCES = (512, 1024, 512, 256, 256, 256)
MEAN_FILL = (123.0, 117.0, 104.0)
CONSTRAINTS = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)
CANDIDATES = 8
BRIGHTNESS, CONTRAST, SATURATION = (-0.12, 0.12), (0.8, 1.25), (0.7, 1.3)
VARIANCE, IOU_THRESH, NEG_PER_POS = (0.1, 0.2), 0.5, 3
LR, BETAS, EPS, DECAY, BIAS_SCALE = 1e-4, (0.9, 0.999), 1e-8, 5e-4, 2.0


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k)


class SSD300(nn.Module):
    def __init__(self, n_fg_class: int):
        super().__init__()
        self.n_class = n_fg_class + 1
        self.VGG16Extractor_0 = nn.Module()
        vgg = self.VGG16Extractor_0
        for i, (a, b) in enumerate(VGG):
            vgg.add_module(f"Conv_{i}", _conv(a, b, 3))
        vgg.L2Norm_0 = nn.Module()
        vgg.L2Norm_0.weight = nn.Parameter(torch.empty(512))
        vgg.add_module("Conv_13", _conv(512, 1024, 3))
        vgg.add_module("Conv_14", _conv(1024, 1024, 1))
        self.ExtraLayers_0 = nn.Module()
        for i, (a, mid, b, _, _) in enumerate(EXTRAS):
            self.ExtraLayers_0.add_module(f"Conv_{2 * i}", _conv(a, mid, 1))
            self.ExtraLayers_0.add_module(f"Conv_{2 * i + 1}", _conv(mid, b, 3))
        self.Multibox_0 = nn.Module()
        for i, (ch, ars) in enumerate(zip(SOURCES, RATIOS)):
            n_box = 2 + 2 * len(ars)
            self.Multibox_0.add_module(f"Conv_{2 * i}", _conv(ch, n_box * 4, 3))
            self.Multibox_0.add_module(f"Conv_{2 * i + 1}", _conv(ch, n_box * self.n_class, 3))
        self.register_buffer("mean", torch.tensor(VGG_MEAN_RGB), persistent=False)

    @staticmethod
    def _c(conv, x, stride=1, pad=1, dilation=1):
        return F.conv2d(x, conv.weight, conv.bias, stride, pad, dilation)

    def forward(self, images):
        vgg = self.VGG16Extractor_0
        x = (images * 255.0 - self.mean).permute(0, 3, 1, 2)
        for i in range(13):
            x = F.relu(self._c(getattr(vgg, f"Conv_{i}"), x))
            if i == 9:
                norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-12)
                conv4_3 = x / norm * vgg.L2Norm_0.weight[:, None, None]
            if i in (1, 3, 9):
                x = F.max_pool2d(x, 2, 2)
            elif i == 6:
                x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=-math.inf) if x.shape[2] % 2 else x, 2, 2)
        x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(self._c(vgg.Conv_13, x, pad=6, dilation=6))
        x = F.relu(self._c(vgg.Conv_14, x, pad=0))
        sources = [conv4_3, x]
        for i, (_, _, _, stride, pad) in enumerate(EXTRAS):
            x = F.relu(self._c(getattr(self.ExtraLayers_0, f"Conv_{2 * i}"), x, pad=0))
            x = F.relu(self._c(getattr(self.ExtraLayers_0, f"Conv_{2 * i + 1}"), x, stride, pad))
            sources.append(x)
        locs, confs = [], []
        for i, s in enumerate(sources):
            n = s.shape[0]
            locs.append(self._c(getattr(self.Multibox_0, f"Conv_{2 * i}"), s).permute(0, 2, 3, 1).reshape(n, -1, 4))
            confs.append(self._c(getattr(self.Multibox_0, f"Conv_{2 * i + 1}"), s).permute(0, 2, 3, 1)
                         .reshape(n, -1, self.n_class))
        return torch.cat(locs, 1), torch.cat(confs, 1)


def default_boxes(size: int = 300) -> torch.Tensor:
    out = []
    for k, (grid, step) in enumerate(zip(GRIDS, STEPS)):
        s, s_next = SIZES[k] / size, math.sqrt(SIZES[k] * SIZES[k + 1]) / size
        for i, j in itertools.product(range(grid), repeat=2):
            cy, cx = (i + 0.5) * step / size, (j + 0.5) * step / size
            out += [(cy, cx, s, s), (cy, cx, s_next, s_next)]
            for ar in RATIOS[k]:
                r = math.sqrt(ar)
                out += [(cy, cx, s / r, s * r), (cy, cx, s * r, s / r)]
    return torch.tensor(out, dtype=torch.float32)


def weight_spec(config: dict) -> list[tuple[str, tuple, tuple]]:
    """He-normal convolutions, zero biases, L2Norm's scale 20."""
    with torch.device("meta"):
        model = SSD300(config["n_fg_class"])
    spec = []
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if len(shape) == 4:
            rule = ("normal", math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))
        elif name.endswith("L2Norm_0.weight"):
            rule = ("const", 20.0)
        else:
            rule = ("const", 0.0)
        spec.append((name, shape, rule))
    return spec


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) x (..., R, 4) yxyx -> (..., K, R); 0 where the union is
    not positive."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = torch.clamp(br - tl, min=0.0).prod(-1)
    union = (a[..., 2:] - a[..., :2]).prod(-1)[..., :, None] + (b[..., 2:] - b[..., :2]).prod(-1)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def draws(generator: torch.Generator, n: int) -> dict:
    """One batch's augmentation draws, in the order they are made."""
    def u(*shape):
        return torch.rand((n, *shape), generator=generator, device=generator.device)

    out = {"brightness": BRIGHTNESS[0] + u(1, 1, 1) * (BRIGHTNESS[1] - BRIGHTNESS[0]),
           "contrast": CONTRAST[0] + u(1, 1, 1) * (CONTRAST[1] - CONTRAST[0]),
           "saturation": SATURATION[0] + u(1, 1, 1) * (SATURATION[1] - SATURATION[0])}
    out["expand"] = u(CANDIDATES) < 0.5
    out["ratio"] = 1.0 + 3.0 * u(CANDIDATES)
    out["scale"] = 0.3 + 0.7 * u(CANDIDATES)
    for key in ("aspect", "uy", "ux"):
        out[key] = u(CANDIDATES)
    out["constraint"] = torch.randint(len(CONSTRAINTS), (n,), generator=generator, device=generator.device)
    out["flip"] = u() < 0.5
    return out


def augment(scenes: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor, d: dict, out: int,
            columns_first: bool = False):
    """(images (N, out, out, 3), boxes (N, R, 4) pixel yxyx, valid (N, R))."""
    n, s = scenes.shape[0], scenes.shape[1]
    mean = scenes.mean(dim=(1, 2, 3), keepdim=True)
    x = (scenes - mean) * d["contrast"] + mean + d["brightness"]
    gray = x.mean(dim=-1, keepdim=True)
    x = torch.clip(gray + (x - gray) * d["saturation"], 0.0, 1.0)

    ratio = torch.where(d["expand"], d["ratio"], 1.0)
    cs = d["scale"]
    f = cs * ratio
    lo, hi = torch.clamp(cs * cs, min=0.5), torch.clamp(1.0 / (cs * cs), max=2.0)
    ar = torch.exp(d["aspect"] * (torch.log(hi) - torch.log(lo)) + torch.log(lo))
    ch, cw = f / torch.sqrt(ar) * s, f * torch.sqrt(ar) * s
    y0 = torch.clamp(s - ch, max=0.0) + d["uy"] * torch.abs(s - ch)
    x0 = torch.clamp(s - cw, max=0.0) + d["ux"] * torch.abs(s - cw)
    cand = torch.stack([y0, x0, y0 + ch, x0 + cw], -1)
    need = torch.tensor(CONSTRAINTS, device=scenes.device)[d["constraint"]]
    least = torch.where(valid[:, None, :], iou(cand, boxes), torch.inf).amin(2)
    ok = least >= need[:, None]
    first = ok.int().argmax(1)
    win = torch.where(ok.any(1)[:, None], cand[torch.arange(n, device=scenes.device), first],
                      torch.tensor([0.0, 0.0, float(s), float(s)], device=scenes.device))

    wy0, wx0, wy1, wx1 = win.unbind(-1)
    theta = torch.zeros(n, 2, 3, device=scenes.device)
    theta[:, 0, 0] = (wx1 - wx0 - 1.0) / (s - 1)
    theta[:, 0, 2] = (wx0 + wx1 - 1.0) / (s - 1) - 1.0
    theta[:, 1, 1] = (wy1 - wy0 - 1.0) / (s - 1)
    theta[:, 1, 2] = (wy0 + wy1 - 1.0) / (s - 1) - 1.0
    rendered = crop(torch.cat([x, torch.ones_like(x[..., :1])], -1), theta, (out, out), columns_first)
    fill = torch.tensor(MEAN_FILL, device=scenes.device) / 255.0
    images = rendered[..., :3] + (1.0 - rendered[..., 3:4]) * fill

    sy = (out - 1) / torch.clamp(wy1 - wy0 - 1.0, min=1e-3)
    sx = (out - 1) / torch.clamp(wx1 - wx0 - 1.0, min=1e-3)
    b = torch.stack([(boxes[..., 0] - wy0[:, None]) * sy[:, None], (boxes[..., 1] - wx0[:, None]) * sx[:, None],
                     (boxes[..., 2] - wy0[:, None]) * sy[:, None], (boxes[..., 3] - wx0[:, None]) * sx[:, None]], -1)
    cy, cx = (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2
    valid = valid & (cy >= 0) & (cy < out) & (cx >= 0) & (cx < out)
    b = torch.clip(b, 0, out)
    flip = d["flip"]
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    flipped = torch.stack([b[..., 0], out - b[..., 3], b[..., 2], out - b[..., 1]], -1)
    return images, torch.where(flip[:, None, None], flipped, b), valid


def encode(anchors: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor):
    """(loc (N, K, 4), conf (N, K)) targets of normalised yxyx ``boxes``;
    ``anchors`` (K, 4) (cy, cx, h, w). A box's best anchor is forced to it
    (the later box wins a shared one); an image without a box gets zeros."""
    n, r = boxes.shape[:2]
    a_yxyx = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2, anchors[:, :2] + anchors[:, 2:] / 2], 1)
    ious = torch.where(valid[:, None, :], iou(a_yxyx, boxes), -1.0)  # (N, K, R)
    index = ious.argmax(2)
    matched_ok = ious.amax(2) >= IOU_THRESH
    best = ious.argmax(1)  # (N, R)
    rows = torch.arange(n, device=boxes.device)
    for i in range(r):
        v = valid[:, i]
        matched_ok[rows, best[:, i]] |= v
        index[rows, best[:, i]] = torch.where(v, i, index[rows, best[:, i]])
    m = torch.gather(boxes, 1, index[..., None].expand(n, index.shape[1], 4))
    cy, hw = (m[..., :2] + m[..., 2:]) / 2, m[..., 2:] - m[..., :2]
    log_hw = torch.log((torch.clamp(hw, min=1e-8) / anchors[:, 2:]).double()).float()
    loc = torch.cat([(cy - anchors[:, :2]) / (VARIANCE[0] * anchors[:, 2:]), log_hw / VARIANCE[1]], -1)
    keep = matched_ok & valid.any(1, keepdim=True)
    return torch.where(keep[..., None], loc, 0.0), torch.where(keep, 1, 0)


def loss(mb_loc, mb_conf, gt_loc, gt_conf):
    pos = gt_conf > 0
    n_pos = torch.clamp(pos.sum().float(), min=1.0)
    d = mb_loc - gt_loc
    ad = d.abs()
    loc = torch.sum(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1) * pos) / n_pos
    ce = -torch.gather(F.log_softmax(mb_conf, -1), -1, gt_conf[..., None])[..., 0]
    neg = torch.where(pos, -torch.inf, ce.detach())
    rank = torch.argsort(torch.argsort(-neg, dim=1, stable=True), dim=1, stable=True)
    hard = rank < NEG_PER_POS * pos.sum(1, keepdim=True)
    return loc, torch.sum(torch.where(pos | hard, ce, 0.0)) / n_pos


class Adam:
    """The SSD optimiser over named parameters, updated in place."""

    def __init__(self, named):
        self.named = list(named)
        self.mu = [torch.zeros_like(p) for _, p in self.named]
        self.nu = [torch.zeros_like(p) for _, p in self.named]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = BETAS
        for (name, p), g, mu, nu in zip(self.named, grads, self.mu, self.nu):
            g = g * BIAS_SCALE if name.rsplit(".", 1)[-1] == "bias" else g + DECAY * p
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g * g, alpha=1 - b2)
            p.sub_(LR * (mu / (1 - b1 ** self.t)) / ((nu / (1 - b2 ** self.t)).sqrt() + EPS))


def train_steps(config: dict, weights: dict, batches, generator: torch.Generator, *, half: bool = False,
                columns_first: bool = False) -> dict:
    """SSD updates from ``weights`` over ``batches`` (``[(scenes uint8,
    boxes, valid)]``), augmenting with draws from ``generator``. Returns
    each step's (loc loss, conf loss), the norm of each leaf's first
    gradient as the optimiser gets it (a bias's doubled, the decay added)
    and of each leaf's change after the last step."""
    device = batches[0][0].device
    with torch.device(device):
        model = SSD300(config["n_fg_class"])
    model.load_state_dict(weights)
    anchors = default_boxes(config["input_size"]).to(device)
    named = list(model.named_parameters())
    start = {k: v.detach().clone() for k, v in named}
    opt = Adam(named)
    losses, grad1 = [], None
    size = config["input_size"]
    for scenes, boxes, valid in batches:
        d = draws(generator, scenes.shape[0])
        if half:
            k = scenes.shape[0] // 2
            scenes, boxes, valid = scenes[:k], boxes[:k], valid[:k]
            d = {key: v[:k] for key, v in d.items()}
        images, b, v = augment(scenes.float() * (1.0 / 255.0), boxes, valid, d, size, columns_first)
        gt_loc, gt_conf = encode(anchors, b / size, v)
        mb_loc, mb_conf = model(images)
        loc, conf = loss(mb_loc, mb_conf, gt_loc, gt_conf)
        grads = torch.autograd.grad(loc + conf, [p for _, p in named])
        if grad1 is None:
            grad1 = {k: float((g * BIAS_SCALE if k.rsplit(".", 1)[-1] == "bias" else g + DECAY * p.detach()).norm())
                     for (k, p), g in zip(named, grads)}
        opt.step(grads)
        losses.append([float(loc.detach()), float(conf.detach())])
    change = {k: float((v.detach() - start[k]).norm()) for k, v in named}
    return {"losses": losses, "grad1": grad1, "change": change}
