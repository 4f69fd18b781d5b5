"""The port's multibox machinery against the JAX package's
(``loans_tpu/ops/multibox.py``, ``loans_tpu/evaluation/metrics.py``), on
the same numpy-seeded inputs, on the CPU.

Tolerances:

* ``default_boxes`` and the host encoder ``MultiboxCoder.encode``: exactly
  equal (the same numpy code on the same inputs);
* ``decode_batch``: 1e-6 relative to the largest box coordinate: the same
  float32 operations, which XLA may fuse (measured at most 1 ulp);
* ``multibox_loss``: both losses to 1e-6 relative, and their gradients
  into ``mb_loc`` and ``mb_conf`` to 1e-6 of each gradient's largest
  entry: float32 sums of up to N * K terms in another order; the hard
  negatives chosen must be the same set, ties included, or a tied
  gradient entry would differ by a whole term;
* ``non_maximum_suppression``: the same kept indices, in the same order,
  as ``_nms_python``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loans_tpu.evaluation.metrics import _nms_python
from loans_tpu.models import ssd as jssd
from loans_tpu.ops import multibox as jmb
from loans_tpu_torch.evaluation.metrics import non_maximum_suppression
from loans_tpu_torch.models import SSD300, SSD512
from loans_tpu_torch.ops import multibox as mb


@pytest.fixture(scope="module")
def coders():
    """The SSD300 coders of the port and of the JAX package."""
    return SSD300().coder(), jssd.SSD300().coder()


@pytest.mark.parametrize("name", ["SSD300", "SSD512"])
def test_default_boxes_are_jax_s(name):
    port = {"SSD300": SSD300, "SSD512": SSD512}[name]().default_bbox()
    ref = getattr(jssd, name)().default_bbox()
    assert port.dtype == ref.dtype == np.float32
    assert port.shape == ({"SSD300": 8732, "SSD512": 24564}[name], 4)
    assert np.array_equal(port, ref)


def _gt(rng, r):
    tl = rng.uniform(0.0, 0.7, (r, 2))
    return np.concatenate([tl, tl + rng.uniform(0.02, 0.3, (r, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["one", "several", "none", "duplicates", "labels"])
def test_host_encoder_is_jax_s(case, coders):
    rng = np.random.default_rng(1)
    coder, ref = coders
    r = {"one": 1, "several": 4, "none": 0, "duplicates": 3, "labels": 5}[case]
    bbox = _gt(rng, r)
    if case == "duplicates":  # two gt share their best anchor: the later one takes it
        bbox[2] = bbox[0]
    label = rng.integers(0, 3, r) if case == "labels" else np.zeros(r, np.int32)
    loc, conf = coder.encode(bbox, label)
    want_loc, want_conf = ref.encode(bbox, label)
    assert loc.dtype == np.float32 and conf.dtype == np.int32
    assert np.array_equal(loc, want_loc) and np.array_equal(conf, want_conf)
    if case == "none":
        assert not loc.any() and not conf.any()
    else:
        assert (conf > 0).sum() >= r - (case == "duplicates")


def test_decode_batch_is_jax_s(coders):
    rng = np.random.default_rng(2)
    coder, ref = coders
    loc = rng.normal(0, 2, (2, 8732, 4)).astype(np.float32)
    loc[0, :10, 2:] = 1e3  # clipped to 10 before exp: finite boxes
    loc[1, :10, 2:] = -1e3
    got = coder.decode_batch(torch.from_numpy(loc)).numpy()
    want = np.asarray(ref.decode_batch(jnp.asarray(loc)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def _loss_inputs(case):
    rng = np.random.default_rng(3)
    n, k, c = 2, 300, 3
    gt_loc = rng.normal(size=(n, k, 4)).astype(np.float32)
    mb_loc = rng.normal(size=(n, k, 4)).astype(np.float32)
    mb_conf = rng.normal(size=(n, k, c)).astype(np.float32)
    gt_conf = np.zeros((n, k), np.int32)
    if case != "no_positive":
        gt_conf[0, rng.choice(k, 7, replace=False)] = rng.integers(1, c, 7)
        gt_conf[1, rng.choice(k, 2, replace=False)] = 1
    if case == "tied":  # a fresh head: every background loss equal
        mb_conf = np.zeros_like(mb_conf)
        mb_conf[..., 0] = 0.25
    return mb_loc, mb_conf, gt_loc, gt_conf


@pytest.mark.parametrize("case", ["random", "tied", "no_positive"])
def test_multibox_loss_and_gradients_are_jax_s(case):
    mb_loc, mb_conf, gt_loc, gt_conf = _loss_inputs(case)

    def jax_loss(loc, conf):
        a, b = jmb.multibox_loss(loc, conf, jnp.asarray(gt_loc), jnp.asarray(gt_conf), k=3)
        return a + b, (a, b)

    (_, (j_loc, j_conf)), (g_loc, g_conf) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(mb_loc), jnp.asarray(mb_conf))
    loc = torch.from_numpy(mb_loc).requires_grad_()
    conf = torch.from_numpy(mb_conf).requires_grad_()
    p_loc, p_conf = mb.multibox_loss(loc, conf, torch.from_numpy(gt_loc), torch.from_numpy(gt_conf), k=3)
    (p_loc + p_conf).backward()
    np.testing.assert_allclose(p_loc.item(), float(j_loc), rtol=1e-6)
    np.testing.assert_allclose(p_conf.item(), float(j_conf), rtol=1e-6)
    for got, want in ((loc.grad.numpy(), np.asarray(g_loc)), (conf.grad.numpy(), np.asarray(g_conf))):
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
        # the same entries carry a gradient: the same hard negatives
        assert np.array_equal(got != 0, want != 0)
    if case == "no_positive":
        assert p_loc.item() == 0.0 and p_conf.item() == 0.0
    if case == "tied":  # k * n_pos negatives per image, the lowest anchor indices first
        chosen = (conf.grad.numpy() != 0).any(-1) & (gt_conf == 0)
        assert chosen.sum(1).tolist() == [21, 6]
        for i in range(2):
            first = np.flatnonzero(gt_conf[i] == 0)[: chosen[i].sum()]
            assert np.array_equal(np.flatnonzero(chosen[i]), first)


@pytest.mark.parametrize("scores", ["untied", "tied", "none"])
def test_nms_is_nms_python(scores):
    rng = np.random.default_rng(4)
    for trial in range(40):
        n = int(rng.integers(0, 50))
        tl = rng.uniform(0, 1, (n, 2))
        bbox = np.concatenate([tl, tl + rng.uniform(0, 0.5, (n, 2))], 1)
        if trial % 3 == 0:
            bbox = np.round(bbox, 1)  # exact duplicates and touching edges
        score = {"untied": rng.uniform(size=n), "tied": rng.integers(0, 3, n).astype(np.float32),
                 "none": None}[scores]
        for thresh in (0.0, 0.3, 0.45, 1.0):
            got = non_maximum_suppression(bbox, thresh, score)
            want = _nms_python(bbox, thresh, score)
            assert got.dtype == want.dtype and np.array_equal(got, want), (trial, thresh)
