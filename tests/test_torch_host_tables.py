"""No table built from Python data inside the hot path
(``loans_tpu_torch/utils/constants.py``), at the small size of
``tests/test_torch_tracing.py`` (Localizer R-18 32²→8², ResnetAssessor ch
8, batch 4, 2 steps a call; the tiny SSD body; the served log dir):

* on the CPU, the steady (second) pooled call of the alternating,
  supervised and SSD bodies, with its chunk from the feed, and
  ``localize_batch``'s forward run with ``torch.tensor`` and
  ``Tensor.new_tensor`` made to raise (the upload's ``as_tensor`` is left
  alone);
* every function whose table is now made once per device and dtype gives
  the bits of its former formula, written out here, in float32 and
  bfloat16, gradients included where the function has one;
* on a card (marker ``cuda``: ``python -m pytest --noconftest
  tests/test_torch_host_tables.py -m cuda``, since ``tests/conftest.py``
  imports JAX), the steady pooled call of the alternating and SSD bodies
  with its feed, and ``localize_batch(sync=False)`` from its forward to
  its return, make no synchronisation under
  ``torch.cuda.set_sync_debug_mode("error")``.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from loans_tpu_torch.data import ssd_device
from loans_tpu_torch.data.device_data import device_chunk_batches
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.inference import localizer as served_module
from loans_tpu_torch.models import ResnetAssessor
from loans_tpu_torch.ops.geometry import Size, corners_to_aabb, scale_corners
from loans_tpu_torch.ops.losses import _relu, smooth_iou_loss
from loans_tpu_torch.ops.rotation_dropout import _OFFDIAG_ZERO, rotation_dropout
from loans_tpu_torch.train import AlternatingConfig, pooled_step
from loans_tpu_torch.utils import tracing
from test_torch_tracing import BATCH, CROP, IMG, K, PHASES, _training, served  # noqa: F401 (served: fixture)

DTYPES = [torch.float32, torch.bfloat16]
INTS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
SIZE = Size(24, 40)
BETA = 1000.0  # smooth_iou_loss's beta at the tie: boxes of ~1e-3 give a union near the 1e-6 floor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest --noconftest "
                    "tests/test_torch_host_tables.py -m cuda)")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _no_tables():
    """``torch.tensor`` and ``Tensor.new_tensor`` raise inside the block."""

    def boom(*args, **kwargs):
        raise AssertionError("a tensor was built from Python data inside the hot path")

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch, "tensor", boom)
        m.setattr(torch.Tensor, "new_tensor", boom)
        yield


@contextlib.contextmanager
def _no_syncs():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _steady_call(kind, device, around_second):
    """Two pooled calls of ``kind`` on ``device``, each with its chunk from
    the feed; the second chunk and call run inside ``around_second()``.
    Returns the second call's metrics."""
    loc_state, ass_state, groups, body = _training(kind)
    for state in (loc_state, ass_state):
        if state is not None:
            state.model.to(device)
    generator = torch.Generator(device).manual_seed(1)
    config = AlternatingConfig(image_size=Size(IMG, IMG))
    chunks = device_chunk_batches(groups, BATCH, K, device=device)
    try:
        for call in range(2):
            with around_second() if call else contextlib.nullcontext():
                loc_state, ass_state, metrics = pooled_step(
                    loc_state, ass_state, next(chunks), generator, K, config, body=body)
    finally:
        chunks.close()
    return metrics


@pytest.mark.parametrize("kind", list(PHASES))
def test_steady_pooled_call_builds_no_table(kind):
    metrics = _steady_call(kind, torch.device("cpu"), _no_tables)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_served_forward_builds_no_table(served):
    inference, frames = served
    inference.finish_batch(inference.localize_batch(frames, sync=False))
    with _no_tables():
        out = inference.localize_batch(frames, sync=False)
    boxes, _, scores, _ = inference.finish_batch(out)
    assert boxes.shape == (BATCH, 1, 4) and scores.shape == (BATCH,)


# -- the former formulas, as the functions computed them before their tables were made once --


def _old_assessor_head(assessor, h):
    fan_in = torch.tensor(float(assessor.fan_in), dtype=h.dtype, device=h.device)
    h = F.linear(h * (1.0 / torch.sqrt(fan_in)), assessor.Dense_0.weight.to(h.dtype))
    return torch.sigmoid(h.float())


def _old_rotation_dropout(theta, ratio, train, generator):
    offdiag_keep = theta.new_tensor(_OFFDIAG_ZERO)
    if ratio == 0.0:
        return theta * offdiag_keep
    if not train:
        return theta * (offdiag_keep + (1.0 - offdiag_keep) * ratio)
    draw = torch.rand((), generator=generator, device=theta.device)
    flag = (draw < ratio).to(theta.dtype)
    return theta * (offdiag_keep + (1.0 - offdiag_keep) * flag)


def _old_scale_corners(corners, image_size):
    half = (corners + 1.0) / 2.0
    return half * corners.new_tensor([image_size.width, image_size.height])


def _old_corners_to_aabb(corners, image_size, clip):
    px = _old_scale_corners(corners, image_size)
    if clip:
        hi = px.new_tensor([image_size.width, image_size.height])
        px = torch.minimum(px.clamp(min=0.0), hi)
    tl, tr, bl, br = px[:, 0], px[:, 1], px[:, 2], px[:, 3]
    return torch.stack([torch.minimum(tl[:, 1], tr[:, 1]), torch.minimum(tl[:, 0], bl[:, 0]),
                        torch.maximum(bl[:, 1], br[:, 1]), torch.maximum(tr[:, 0], br[:, 0])], dim=1)


def _smooth_iou_parts(pred, gt, beta):
    tl = torch.maximum(pred[:, :2], gt[:, :2])
    br = torch.minimum(pred[:, 2:], gt[:, 2:])
    z = (br - tl) * beta
    wh = torch.logaddexp(z, torch.zeros_like(z)) / beta
    inter = wh[:, 0] * wh[:, 1]
    area_p = _relu(pred[:, 2:] - pred[:, :2]).prod(dim=1)
    area_g = _relu(gt[:, 2:] - gt[:, :2]).prod(dim=1)
    return inter, area_p + area_g - inter


def _old_smooth_iou_loss(pred, gt, beta, clamp=False):
    """``clamp``: the floor as ``clamp``, whose gradient at the tie is not
    JAX's (the loss never took this form)."""
    inter, union = _smooth_iou_parts(pred, gt, beta)
    union = union.clamp(min=1e-6) if clamp else torch.maximum(union, inter.new_tensor(1e-6))
    return 1.0 - (inter / union).mean()


def _old_tables(m):
    """Patch ``data/ssd_device.py``'s tables back to the tensors it built
    on every call."""
    m.setattr(ssd_device, "device_table", lambda values, dtype, device: torch.tensor(values, device=device))
    m.setattr(ssd_device, "_mean_fill", lambda dtype, device: torch.tensor(
        ssd_device.MEAN_FILL, dtype=dtype, device=device) / 255.0)


def _bits(t):
    return t.detach().view(INTS[t.dtype]) if t.dtype in INTS else t.detach()


def _assert_bits(new, old):
    assert new.dtype == old.dtype and new.shape == old.shape
    assert torch.equal(_bits(new), _bits(old))


def _tie_rows(dtype):
    """(pred, gt) (2, 4) yxyx boxes, the first row's smooth-IoU union (at
    ``BETA``) exactly on the loss's 1e-6 floor in ``dtype``, the second
    an ordinary pair. gt's right edge lies past pred's, so it moves gt's
    area and not the intersection, and the union rises with it by less
    than one of its units a step: bisect on the edge's bit pattern."""
    floor = torch.full((), 1e-6, dtype=dtype)
    pred = torch.tensor([[0.0, 0.0, 1.3e-3, 1.3e-3]], dtype=dtype)

    def gt_row(bits):
        edge = torch.tensor([bits], dtype=INTS[dtype]).view(dtype)
        y0 = torch.tensor([1.8e-3], dtype=dtype)
        return torch.stack([y0, torch.zeros_like(y0), y0 + 2.5e-5, edge], dim=1)

    def union(bits):
        return _smooth_iou_parts(pred, gt_row(bits), BETA)[1][0]

    lo, hi = (int(torch.tensor(v, dtype=dtype).view(INTS[dtype])) for v in (1.4e-3, 0.2))
    assert union(lo) < floor <= union(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if union(mid) < floor else (lo, mid)
    assert union(hi) == floor
    other_pred = torch.tensor([[1e-3, 2e-3, 6e-3, 5e-3]], dtype=dtype)
    other_gt = torch.tensor([[2e-3, 1e-3, 5e-3, 7e-3]], dtype=dtype)
    return torch.cat([pred, other_pred]), torch.cat([gt_row(hi), other_gt])


def _case_assessor(dtype):
    torch.manual_seed(0)
    assessor = ResnetAssessor(ch=8, output_dim=4, in_size=Size(CROP, CROP), dtype=dtype)
    x = torch.rand(64, CROP, CROP, 3, generator=torch.Generator().manual_seed(2)).to(dtype)
    features = []
    out = assessor(x, features)
    return [(out, _old_assessor_head(assessor, features[0]))]


def _case_rotation_dropout(dtype):
    theta = torch.randn(BATCH, 2, 3, generator=torch.Generator().manual_seed(5)).to(dtype)
    pairs = []
    for ratio in (0.0, 0.5):
        for train in (True, False):
            for seed in range(4):  # train mode at 0.5 draws both ways over the seeds
                new = rotation_dropout(theta, ratio, train=train, generator=torch.Generator().manual_seed(seed))
                old = _old_rotation_dropout(theta, ratio, train, torch.Generator().manual_seed(seed))
                pairs.append((new, old))
    return pairs


def _corners(dtype):
    return (2.4 * torch.rand(BATCH, 4, 2, generator=torch.Generator().manual_seed(6)) - 1.2).to(dtype)


def _case_scale_corners(dtype):
    corners = _corners(dtype)
    return [(scale_corners(corners, SIZE), _old_scale_corners(corners, SIZE))]


def _case_corners_to_aabb(dtype):
    corners = _corners(dtype)
    return [(corners_to_aabb(corners, SIZE, clip), _old_corners_to_aabb(corners, SIZE, clip))
            for clip in (True, False)]


def _case_smooth_iou_loss(dtype):
    """The loss and both gradients at a tie with the 1e-6 floor, where
    ``torch.maximum``'s subgradient (JAX's, half to each side) and not
    ``clamp``'s must reach the boxes."""
    pairs, grads = [], {}
    for name, fn in (("new", lambda p, g: smooth_iou_loss(p, g, BETA)),
                     ("old", lambda p, g: _old_smooth_iou_loss(p, g, BETA)),
                     ("clamp", lambda p, g: _old_smooth_iou_loss(p, g, BETA, clamp=True))):
        pred, gt = (t.requires_grad_() for t in _tie_rows(dtype))
        loss = fn(pred, gt)
        loss.backward()
        grads[name] = (loss, pred.grad, gt.grad)
    pairs.extend(zip(grads["new"], grads["old"]))
    assert not torch.equal(_bits(grads["clamp"][2]), _bits(grads["old"][2]))
    return pairs


def _ssd_inputs(dtype):
    g = torch.Generator().manual_seed(7)
    n, s = 6, 24
    scenes = torch.rand(n, s, s, 3, generator=g).to(dtype)
    lo = 10 * torch.rand(n, 2, 2, generator=g)
    boxes = torch.cat([lo, lo + 2 + 10 * torch.rand(n, 2, 2, generator=g)], -1).to(dtype)
    valid = torch.tensor([[True, True], [True, False], [False, False]] * 2)
    return scenes, boxes, valid, s


def _case_augment_windows(dtype):
    scenes, boxes, valid, s = _ssd_inputs(dtype)
    draws = ssd_device.draw_ssd_augment(torch.Generator().manual_seed(8), scenes)
    new = ssd_device.augment_windows(draws, boxes, valid, s)
    with pytest.MonkeyPatch.context() as m:
        _old_tables(m)
        old = ssd_device.augment_windows(draws, boxes, valid, s)
    return [(new, old)]


def _case_ssd_augment_batch(dtype):
    scenes, boxes, valid, _ = _ssd_inputs(dtype)
    draws = ssd_device.draw_ssd_augment(torch.Generator().manual_seed(9), scenes)
    new = ssd_device.ssd_augment_batch(scenes, boxes, valid, 16, draws=draws)
    with pytest.MonkeyPatch.context() as m:
        _old_tables(m)
        old = ssd_device.ssd_augment_batch(scenes, boxes, valid, 16, draws=draws)
    return list(zip(new, old))


CASES = {name[len("_case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("_case_")}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", list(CASES))
def test_table_made_once_keeps_the_bits(case, dtype):
    pairs = CASES[case](dtype)
    assert pairs
    for new, old in pairs:
        _assert_bits(new, old)


def test_table_is_made_once_per_device_and_dtype():
    from loans_tpu_torch.utils.constants import device_table

    a = device_table((1.0, 2.0), torch.float32, torch.device("cpu"))
    assert device_table((1.0, 2.0), torch.float32, torch.device("cpu")) is a
    assert device_table((1.0, 2.0), torch.bfloat16, torch.device("cpu")) is not a
    with torch.inference_mode():
        b = device_table((3.0,), torch.float32, torch.device("cpu"))
    assert not b.is_inference() and not b.requires_grad
    x = torch.ones(1, requires_grad=True)
    (x * b).sum().backward()  # a table made while serving can be saved for a backward
    assert x.grad.tolist() == [3.0]


# -- on the card --


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["alternating", "ssd"])
def test_steady_pooled_call_makes_no_sync_on_the_card(kind, cuda_device):
    metrics = _steady_call(kind, cuda_device, _no_syncs)
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.cuda
def test_served_forward_makes_no_sync_on_the_card(served, cuda_device, monkeypatch):
    """From the forward's span to ``localize_batch``'s return: the upload
    before it is a pageable copy, and stays one."""
    log_dir, frames = served[0].log_dir, served[1]
    inference = LocalizerInference(log_dir, device=cuda_device, use_assessor=True)
    inference.finish_batch(inference.localize_batch(frames, sync=False))

    def span(name):
        if name == "loans.serve.forward":
            torch.cuda.set_sync_debug_mode("error")
        return tracing.span(name)

    monkeypatch.setattr(served_module, "span", span)
    try:
        out = inference.localize_batch(frames, sync=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    boxes, _, scores, _ = inference.finish_batch(out)
    assert boxes.shape == (BATCH, 1, 4) and np.isfinite(scores).all()
