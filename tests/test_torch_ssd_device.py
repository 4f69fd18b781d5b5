"""The SSD device path of the port (``data/ssd_device.py``,
``train/ssd_steps.py``, the pooled step over the SSD body) against the JAX
package's (``loans_tpu/data/ssd_device.py``, ``loans_tpu/train/
ssd_steps.py``) on the same numpy-seeded inputs, on the CPU (the plain
crop; the card runs K1's forward in its place, held to it in
``chip_smoke.py``).

Randomness: the augmentation's draws are JAX's own, made with JAX's keys
as ``ssd_augment_batch`` splits them, and handed to the port's apply
function (``draws=``); seeds are never compared.

Tolerances, with their reasons:

* ``pairwise_iou_yxyx``: 1e-7 absolute (the same float32 operations);
* ``encode_batch``: conf exactly; loc 1e-6 absolute (offsets up to 4 here,
  measured 2.4e-7: one ulp). The log-size offsets take their log in
  float64: on the CPU, the first float32 ``torch.log`` after a large
  multithreaded elementwise op (a model's weight init is one) missed by up
  to 1.45e-4 in some fresh processes. ``test_encode_batch_after_a_model_init``
  holds fresh processes, each after an SSD300 init, to the same bound;
* ``ssd_augment_batch``: valid exactly; boxes 1e-3 px; images 2e-4: the
  windows come from float32 exp/log/sqrt of the draws, so a sample's
  position in a scene of up to 4 x 300 px is a few ulps of 1200 (1.2e-4
  px each) apart, and the noise scenes step by up to 1 between pixels
  (measured 4.2e-5 at 300², 0 at 64²);
* the optimizer against optax: 1e-6 relative (the same float32 update
  rule in another operation order, over four steps: measured 1.5 ulp);
* one and two SSD steps (SSD300, batch 2, bridged weights, lr 1e-4):
  step 1's losses 1e-5 relative (float32 networks; measured 2.3e-6);
  step 2's 1e-3: after step 1 up to 1% of the weights stand 2·lr apart
  (below), and that one step moves the loss from 27 to 1019 (the SSD's
  raw activations are in the hundreds), so a small share of it shows in
  step 2 (measured 1.3e-4 in loss/loc, 1.2e-5 in loss). Parameters
  within 2·lr per step everywhere (Adam moves a weight by about lr in its
  gradient's sign, and a gradient within float32 error of 0 may take
  either sign; measured 2.00003·lr after one, the excess the float32
  rounding of the weights). After step 1 they are
  within 1e-6 of JAX's on 99% of all entries (measured 99.9%) and
  wherever JAX's first moment is at least a tenth of its tensor's
  largest, as ``test_torch_train.py`` holds the localizer; after step 2,
  whose gradients follow weights that already differ in a deep network
  without normalization, on 80% (measured 90.5%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_models import assert_close_rel  # noqa: E402
from test_torch_ssd_models import port_ssd, ssd_variables  # noqa: E402

from loans_tpu.data import ssd_device as jsd
from loans_tpu.models import ssd as jssd
from loans_tpu.train import state as jstate
from loans_tpu.train.ssd_steps import ssd_optimizer
from loans_tpu_torch.data import ssd_device as sd
from loans_tpu_torch.data.device_augment import Jitter
from loans_tpu_torch.data.device_data import device_chunk_batches
from loans_tpu_torch.models import SSD300
from loans_tpu_torch.train import SSDAdam, TrainState, pooled_step

LR = 1e-4


def _boxes(rng, n, r, size):
    tl = rng.uniform(0, 0.6 * size, (n, r, 2))
    return np.concatenate([tl, tl + rng.uniform(0.1 * size, 0.4 * size, (n, r, 2))], -1).astype(np.float32)


def test_pairwise_iou_is_jax_s():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 1, 40, 1.0)[0], _boxes(rng, 1, 7, 1.0)[0]
    b[3] = [0.2, 0.2, 0.2, 0.5]  # zero area: union of a box with it is the box
    b[4] = [0.9, 0.9, 0.95, 0.95]  # disjoint from most
    got = sd.pairwise_iou_yxyx(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jsd.pairwise_iou_yxyx(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_encode_batch_is_jax_s():
    """Padding, a shared best anchor (the later gt wins), an image with no
    valid box, and labels."""
    coder = jssd.SSD300().coder()
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 4, 3, 1.0)
    valid = np.ones((4, 3), bool)
    valid[1, 2] = False  # padding
    boxes[2, 2] = boxes[2, 0]  # duplicate: the same best anchor
    valid[3] = False  # no valid box: all-zero targets
    labels = rng.integers(0, 2, (4, 3)).astype(np.int32)
    args = [coder.default_bbox, coder.default_yxyx, boxes, valid, labels]
    want_loc, want_conf = jsd.encode_batch(*map(jnp.asarray, args))
    got_loc, got_conf = sd.encode_batch(*map(torch.from_numpy, args))
    assert np.array_equal(got_conf.numpy(), np.asarray(want_conf))
    np.testing.assert_allclose(got_loc.numpy(), np.asarray(want_loc), rtol=0, atol=ENCODE_LOC_TOL)
    assert not got_conf[3].any() and not got_loc[3].any()
    assert (got_conf[2] == labels[2, 2] + 1).any() and not (got_conf[1] == labels[1, 2] + 1).all()


ENCODE_LOC_TOL = 1e-6
FRESH = r"""
import sys
import numpy as np, torch
from loans_tpu_torch.data import ssd_device as sd
from loans_tpu_torch.models import SSD300
z = np.load(sys.argv[1])
SSD300()  # the weight init runs large multithreaded elementwise ops
loc, conf = sd.encode_batch(*(torch.from_numpy(z[k]) for k in ("d", "y", "b", "v", "l")))
np.savez(sys.argv[2], loc=loc.numpy(), conf=conf.numpy())
"""


def _encode_inputs():
    coder = jssd.SSD300().coder()
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 4, 3, 1.0)
    valid = np.ones((4, 3), bool)
    valid[1, 2] = False
    labels = rng.integers(0, 2, (4, 3)).astype(np.int32)
    return [coder.default_bbox, coder.default_yxyx, boxes, valid, labels]


def test_encode_batch_after_a_model_init(tmp_path):
    """``encode_batch``'s first call in each of 4 fresh processes, just
    after an SSD300 init, matches JAX to ``ENCODE_LOC_TOL``. Its float32 log
    missed there by up to 1.45e-4 in about one process in four (on 8
    threads; on one thread, never)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    args = _encode_inputs()
    want_loc, want_conf = jsd.encode_batch(*map(jnp.asarray, args))
    np.savez(tmp_path / "in.npz", **dict(zip("dybvl", args)))
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", FRESH, str(tmp_path / "in.npz"), str(tmp_path / f"{i}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(4)]
    for proc in procs:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out.decode()
    for i in range(4):
        with np.load(tmp_path / f"{i}.npz") as z:
            assert np.array_equal(z["conf"], np.asarray(want_conf))
            np.testing.assert_allclose(z["loc"], np.asarray(want_loc), rtol=0, atol=ENCODE_LOC_TOL,
                                       err_msg=f"process {i}")


def jax_draws(key, n, v=8):
    """The draws ``ssd_augment_batch`` makes from ``key``, in its key order
    (``ssd_device.py:149-177``; the photometric three from ``k_photo``)."""
    k_photo, k_expand, k_scale, k_ar, k_pos, k_con, k_flip, k_ratio = jax.random.split(key, 8)
    k_bright, k_contrast, k_sat = jax.random.split(k_photo, 3)

    def t(x):
        return torch.from_numpy(np.array(x))

    jitter = Jitter(
        t(jax.random.uniform(k_bright, (n, 1, 1, 1), minval=-0.12, maxval=0.12)),
        t(jax.random.uniform(k_contrast, (n, 1, 1, 1), minval=0.8, maxval=1.25)),
        t(jax.random.uniform(k_sat, (n, 1, 1, 1), minval=0.7, maxval=1.3)),
    )
    uy, ux = jax.random.uniform(k_pos, (2, n, v))
    return sd.SSDDraws(
        jitter=jitter,
        expand=t(jax.random.bernoulli(k_expand, 0.5, (n, v))),
        ratio=t(jax.random.uniform(k_ratio, (n, v), minval=1.0, maxval=4.0)),
        scale=t(jax.random.uniform(k_scale, (n, v), minval=0.3, maxval=1.0)),
        aspect=t(jax.random.uniform(k_ar, (n, v))),
        uy=t(uy),
        ux=t(ux),
        constraint=t(jax.random.randint(k_con, (n,), 0, len(sd.CONSTRAINTS))).long(),
        flip=t(jax.random.bernoulli(k_flip, 0.5, (n, 1, 1, 1)))[:, 0, 0, 0],
    )


@pytest.mark.parametrize("size,out", [(64, 48), (300, 300)])
def test_augment_with_jax_draws_is_jax_s(size, out):
    n, r = 12, 3
    rng = np.random.default_rng(2)
    scenes = rng.uniform(size=(n, size, size, 3)).astype(np.float32)
    boxes = _boxes(rng, n, r, size)
    valid = rng.uniform(size=(n, r)) < 0.7
    valid[0] = False  # no gt: any window satisfies
    valid[1] = True
    key = jax.random.key(3)
    want = jsd.ssd_augment_batch(key, jnp.asarray(scenes), jnp.asarray(boxes), jnp.asarray(valid), out)
    draws = jax_draws(key, n)
    got = sd.ssd_augment_batch(torch.from_numpy(scenes), torch.from_numpy(boxes), torch.from_numpy(valid), out,
                               draws=draws)
    images, b, v = (np.asarray(w) for w in want)
    assert got[0].shape == (n, out, out, 3)
    assert np.array_equal(got[2].numpy(), v)
    np.testing.assert_allclose(got[1].numpy(), b, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0].numpy(), images, rtol=0, atol=2e-4)
    # the draws exercise expansion (mean fill), crops and flips
    win = sd.augment_windows(draws, torch.from_numpy(boxes), torch.from_numpy(valid), size)
    sides = (win[:, 2:] - win[:, :2]) / size
    assert (sides > 1.05).any() and (sides < 0.95).any() and draws.flip.any() and not draws.flip.all()


def test_draws_follow_jax_s_distributions():
    gen = torch.Generator().manual_seed(0)
    d = sd.draw_ssd_augment(gen, torch.zeros(4096, 2, 2, 3))
    assert d.expand.dtype == torch.bool and 0.45 < d.expand.float().mean() < 0.55
    for x, lo, hi in ((d.ratio, 1.0, 4.0), (d.scale, 0.3, 1.0), (d.aspect, 0.0, 1.0), (d.uy, 0.0, 1.0),
                      (d.jitter.brightness, -0.12, 0.12), (d.jitter.contrast, 0.8, 1.25)):
        assert lo <= float(x.min()) and float(x.max()) < hi and abs(float(x.mean()) - (lo + hi) / 2) < 0.05 * (hi - lo)
    assert set(d.constraint.tolist()) == set(range(len(sd.CONSTRAINTS)))
    assert 0.45 < d.flip.float().mean() < 0.55


class _Tiny(nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)))
        self.conv.bias = nn.Parameter(torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)))
        self.norm = nn.Module()
        self.norm.weight = nn.Parameter(torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)))


def test_optimizer_is_optax_s():
    """Doubled bias gradients, 5e-4 decay on the rest (L2Norm's scale
    among them), Adam, and a learning rate changed at run time."""
    rng = np.random.default_rng(4)
    model = _Tiny(rng)
    params = {"conv": {"kernel": model.conv.weight.detach().numpy().copy(),
                       "bias": model.conv.bias.detach().numpy().copy()},
              "norm": {"scale": model.norm.weight.detach().numpy().copy()}}
    tx = ssd_optimizer(1e-2)
    opt_state = tx.init(params)
    opt = SSDAdam(model, lr=1e-2)
    torch_of = {("conv", "kernel"): model.conv.weight, ("conv", "bias"): model.conv.bias,
                ("norm", "scale"): model.norm.weight}
    for step in range(4):
        if step == 2:
            opt_state.hyperparams["learning_rate"] = jnp.asarray(3e-3)
            TrainState(model=model, optimizer=opt).with_learning_rate(3e-3)
        grads = {m: {leaf: rng.normal(size=v.shape).astype(np.float32) for leaf, v in tree.items()}
                 for m, tree in params.items()}
        if step == 1:
            grads["norm"]["scale"][:] = 0.0  # decay alone moves it
            model.norm.weight.grad = None  # no gradient counts as zero
        for (m, leaf), p in torch_of.items():
            if not (step == 1 and m == "norm"):
                p.grad = torch.from_numpy(grads[m][leaf])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
        for (m, leaf), p in torch_of.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[m][leaf]), rtol=1e-6, atol=1e-6)
    # the rule itself: a bias moved as Adam on 2 g, not g (step 1 of a fresh pair)
    fresh = _Tiny(np.random.default_rng(5))
    b0 = fresh.conv.bias.detach().clone()
    opt = SSDAdam(fresh, lr=1.0)
    for p in fresh.parameters():
        p.grad = torch.full_like(p, 1e-9)
    opt.step()
    # Adam's first step is lr * g / (|g| + eps): 2g gives 2e-9 / (2e-9 + 1e-8)
    np.testing.assert_allclose((b0 - fresh.conv.bias.detach()).numpy(), 2e-9 / (2e-9 + 1e-8), rtol=1e-5)


def _jax_state(params):
    tx = ssd_optimizer(LR)
    return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                             opt_state=tx.init(params), tx=tx)


@pytest.fixture(scope="module")
def step_setup():
    variables = ssd_variables("SSD300", seed=6, conf_scale=1e-2, loc_scale=1e-2)
    rng = np.random.default_rng(7)
    n_pool = 4
    pool = {
        "scenes": rng.integers(0, 256, (n_pool, 300, 300, 3), dtype=np.uint8),
        "boxes": _boxes(rng, n_pool, 2, 300),
        "valid": np.array([[True, True], [True, False], [True, True], [True, False]]),
    }
    return variables, pool


def test_one_and_two_ssd_steps_match_jax(step_setup, monkeypatch):
    """Two steps of the pooled SSD body with the augmentation, JAX's
    ``ssd_pooled_body`` one step at a time (its scan runs the same
    function), the port's through ``pooled_step`` on the index chunk of
    ``device_chunk_batches`` (the CLI test runs the body without the
    augmentation)."""
    augment = True
    variables, pool = step_setup
    jmodel = jssd.SSD300()
    coder = jmodel.coder()
    jbody = jax.jit(jsd.ssd_pooled_body(jmodel, coder, 300, augment=augment))
    chunk = next(device_chunk_batches({"train": pool}, 2, 2, seed=0, device="cpu"))
    idx = chunk["idx"]["train"].numpy()
    keys = jax.random.split(jax.random.key(8), 2)
    jstate_, j_metrics = _jax_state(variables["params"]), []
    for t in range(2):
        batch = {k: jnp.asarray(v[idx[t]]) for k, v in pool.items()}
        jstate_, _, m = jbody(jstate_, None, batch, keys[t])
        j_metrics.append({k: float(v) for k, v in m.items()})
        if t == 0:
            after_one = _params_and_moment(jstate_)

    draws = iter([jax_draws(keys[0], 2), jax_draws(keys[1], 2)])
    monkeypatch.setattr(sd, "draw_ssd_augment", lambda generator, scenes: next(draws))
    model = port_ssd("SSD300", variables).train()
    state = TrainState(model=model, optimizer=SSDAdam(model, lr=LR))
    body = sd.SSDPooledBody(SSD300().coder(), 300, augment=augment)
    one = {"pools": chunk["pools"], "idx": {"train": chunk["idx"]["train"][:1]}}
    state, _, m1 = pooled_step(state, None, one, None, steps_per_call=1, body=body)
    for k in ("loss", "loss/loc", "loss/conf"):
        assert_close_rel(m1[k].item(), j_metrics[0][k], 1e-5)
    _hold_params(model, variables, after_one, 1)
    two = {"pools": chunk["pools"], "idx": {"train": chunk["idx"]["train"][1:]}}
    state, _, m2 = pooled_step(state, None, two, None, steps_per_call=1, body=body)
    for k in ("loss", "loss/loc", "loss/conf"):
        assert_close_rel(m2[k].item(), j_metrics[1][k], 1e-3)
    assert state.step == 2
    _hold_params(model, variables, _params_and_moment(jstate_), 2)


def _params_and_moment(state):
    """JAX's parameters and Adam first moment, as numpy trees."""
    mu = state.opt_state.inner_state[2][0].mu
    return jax.tree_util.tree_map(np.asarray, (state.params, mu))


def _hold_params(model, variables, want, steps):
    from loans_tpu_torch import bridge

    params, mu = (bridge.ssd_state_dict(model, tree) for tree in want)
    start = bridge.ssd_state_dict(model, variables["params"])
    close = total = 0
    for key, p in model.state_dict().items():
        diff = np.abs(p.numpy() - params[key].numpy())
        assert diff.max() <= 2 * steps * LR + 1e-7, key  # + the weights' own float32 rounding
        m = np.abs(mu[key].numpy())
        if steps == 1:  # from equal weights, the gradients agree where they are not ~0
            assert diff[m >= 0.1 * m.max()].max() <= 1e-6, key
        if not key.endswith("bias"):  # the decay moves every weight (a dead ReLU's bias may stay)
            assert not torch.equal(p, start[key]), key
        close, total = close + int((diff <= 1e-6).sum()), total + diff.size
    assert close >= (0.99 if steps == 1 else 0.8) * total
