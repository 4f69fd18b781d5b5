"""Training slice of the PyTorch port against the JAX package.

Models at a small size (Localizer R-18 64²→16², ResnetAssessor ch 8,
batch 8), weights drawn with numpy from a seed in the JAX modules' shapes
and carried into the port by ``loans_tpu_torch.bridge``; the localizer
head starts as the reference's (zero weights), so step 1's backbone
gradient is exactly 0 and step 2 is the first to train the backbone.
Batches are seeded uint8, as the device pools hold them. The JAX step is
``alternating_step_body`` jitted, compiled once per module.

Tolerances, with their reasons:

* losses and metrics: 1e-5 relative (float32 on both sides).
* assessor parameters: 1e-6 absolute (Adam steps of lr = 1e-3 from
  gradients that agree to float32 rounding; measured 7e-8).
* BatchNorm running statistics: 1e-5 of each tensor's largest entry (the
  stem's variance is ~1e4; measured 4e-6).
* localizer gradients at step 2: JAX's float32 gradients on the CPU are
  off by up to 2% of a tensor's largest entry against a float64
  evaluation of the same step (stage 3's first block), while the port's
  are within 2e-5. So the port's Adam first moment is held to JAX's at
  3e-2, and the gradient is held tightly in float64 instead: JAX under
  x64 against the port in double precision, 1e-5 (measured 4.6e-6), and
  1e-4 for the head, which JAX computes in float32; the port's float32
  against it, 1e-4.
* localizer parameters after step 2: Adam moves each weight by about
  0.74·lr in the direction of its gradient's sign, whatever the
  gradient's size, so where a gradient is within JAX's error of 0 the
  two can step in opposite directions. Parameters agree to 1e-6 where
  JAX's first moment is at least a tenth of its tensor's largest, and to
  2·lr everywhere.
"""

import copy
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from test_torch_models import random_variables  # noqa: E402

from loans_tpu import models as jmodels
from loans_tpu.data import device_data as jdata
from loans_tpu.ops import geometry as jgeo
from loans_tpu.ops import losses as jlosses
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.train import state as jstate
from loans_tpu.train import steps as jsteps
from loans_tpu.train.loop import Hook as JHook, _crossed as j_crossed
from loans_tpu_torch import bridge, models
from loans_tpu_torch.bridge import _torch_leaf
from loans_tpu_torch.data import device_data
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.ops import geometry, losses, stn
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.ops.rotation_dropout import rotation_dropout
from loans_tpu_torch.train import (
    AdamAmsgrad,
    AlternatingConfig,
    CommandChannel,
    Hook,
    MetricsLog,
    Trainer,
    alternating_step,
    checkpoint,
    create_train_state,
    make_eval_step,
    multiplicative_lr_decay,
    pooled_step,
    two_state_lr_shifter,
)
from loans_tpu_torch.train.loop import _crossed

IMG, CROP, BATCH, CH, LR = 64, 16, 8, 8, 1e-3
POOL_SCENES, POOL_CROPS = 24, 32
MANIFEST = {
    "localizer": {"model": "Localizer", "kwargs": {
        "out_size": [CROP, CROP], "n_layers": 18, "input_size": [IMG, IMG]}},
    "assessor": {"model": "ResnetAssessor", "kwargs": {"ch": CH}},
    "snapshot_names": ["Localizer", "ResnetAssessor"],
}

torch.set_num_threads(min(4, torch.get_num_threads()))


# -- shared weights, states and batches --------------------------------------
def jax_models():
    return (
        jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG)),
        jmodels.ResnetAssessor(ch=CH),
    )


@pytest.fixture(scope="module")
def weights():
    jl, ja = jax_models()
    loc = random_variables(jl, jnp.zeros((2, IMG, IMG, 3)), seed=1, train=False)
    head = loc["params"]["param_predictor"]
    head["kernel"] = np.zeros_like(head["kernel"])  # the reference's init
    ass = random_variables(ja, jnp.zeros((2, CROP, CROP, 3)), seed=2)
    return loc, ass


def jax_state(params, batch_stats=None):
    tx = jstate.adam_amsgrad(LR)
    params = jax.tree.map(jnp.asarray, params)
    return jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, batch_stats or {}),
        opt_state=tx.init(params), tx=tx,
    )


def port_models(weights):
    loc_v, ass_v = weights
    loc = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG))
    loc.load_state_dict(bridge.localizer_state_dict(loc, loc_v["params"], loc_v["batch_stats"]))
    ass = models.ResnetAssessor(ch=CH, in_size=Size(CROP, CROP))
    ass.load_state_dict(bridge.assessor_state_dict(ass, ass_v["params"]))
    return loc, ass


def port_states(weights):
    loc, ass = port_models(weights)
    return create_train_state(loc, LR), create_train_state(ass, LR)


def make_batch(rng, n=BATCH):
    return {
        "real": rng.integers(0, 256, (n, CROP, CROP, 3), dtype=np.uint8),
        "labels": rng.uniform(size=(n, 1)).astype(np.float32),
        "unlabeled": rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8),
    }


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_localizer_sd(model, state):
    return bridge.localizer_state_dict(model, state.params, state.batch_stats)


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} * {scale}"


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def jax_mu(state):
    """Adam first moments of an optax amsgrad state, flat by flax path."""
    return bridge.flatten_variables(state.opt_state.inner_state[0].mu)


# -- BatchNorm ----------------------------------------------------------------
def test_batchnorm_running_stats_match_flax():
    """A train-mode forward updates the running statistics as flax does:
    with the *biased* batch variance (``nn.BatchNorm2d`` folds the
    unbiased one, here n/(n-1) = 8/7 too large) and weight 0.9."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (2, 2, 2, 5)).astype(np.float32)  # n = 8 per channel
    mean0 = rng.normal(size=5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=2e-5)
    variables = {"params": {"scale": jnp.ones(5), "bias": jnp.zeros(5)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    y_want, updates = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    def run(module):
        module.running_mean.copy_(torch.from_numpy(mean0))
        module.running_var.copy_(torch.from_numpy(var0))
        y = module.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        return y.detach().permute(0, 2, 3, 1).numpy(), module

    with torch.no_grad():
        y, port = run(models.resnet.batch_norm(5))
        _, plain = run(nn.BatchNorm2d(5, eps=2e-5, momentum=0.1))
    np.testing.assert_allclose(y, np.asarray(y_want), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), updates["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), updates["batch_stats"]["var"], rtol=1e-6)
    with pytest.raises(AssertionError):  # the fault this class repairs
        np.testing.assert_allclose(plain.running_var.numpy(), updates["batch_stats"]["var"], rtol=1e-3)


# -- optimizer ------------------------------------------------------------------
def test_adam_amsgrad_matches_optax_with_lr_change():
    """Six updates from the same gradients; the learning rate drops to
    1e-4 before step 4 (``with_learning_rate``, nothing rebuilt).
    Tolerance 1e-7 absolute on parameters of order 1 with steps of 1e-3:
    float32 rounding of the same operations."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 10.0 ** -k2, s).astype(np.float32)
              for k2, (k, s) in enumerate(shapes.items())} for _ in range(6)]

    jstate_ = jax_state(params)
    torch_params = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    state = create_train_state(nn.ParameterDict(torch_params), LR)
    assert isinstance(state.optimizer, AdamAmsgrad)
    for step, g in enumerate(grads):
        if step == 3:
            jstate_ = jstate_.with_learning_rate(1e-4)
            state = state.with_learning_rate(1e-4)
        jstate_ = jstate_.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        for k, v in g.items():
            torch_params[k].grad = torch.from_numpy(v)
        state.apply_gradients()
        for k in params:
            np.testing.assert_allclose(torch_params[k].detach().numpy(),
                                       np.asarray(jstate_.params[k]), rtol=0, atol=1e-7)
    assert state.step == 6 and state.learning_rate == pytest.approx(1e-4)
    assert state.optimizer.param_groups[0]["step"] == 6
    optax_state = jstate_.opt_state.inner_state[0]
    for k, p in torch_params.items():
        np.testing.assert_allclose(state.optimizer.state[p]["nu_max"].numpy(),
                                   np.asarray(optax_state.nu_max[k]), rtol=1e-5)

    # torch's own amsgrad takes the max of the raw moment: another rule
    t_params = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.Adam(t_params.values(), lr=LR, amsgrad=True, eps=1e-8)
    for g in grads[:3]:
        for k, v in g.items():
            t_params[k].grad = torch.from_numpy(v)
        opt.step()
    optax_params = jax_state(params)
    for g in grads[:3]:
        optax_params = optax_params.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
    assert not np.allclose(t_params["a"].detach().numpy(), np.asarray(optax_params.params["a"]),
                           rtol=0, atol=1e-7)


# -- alternating steps ---------------------------------------------------------
@pytest.fixture(scope="module")
def two_steps(weights):
    """Two alternating steps in both frameworks from the same weights and
    batches; a record after each step."""
    jl, ja = jax_models()
    body = jax.jit(jsteps.alternating_step_body(jl, ja, jsteps.AlternatingConfig(image_size=JSize(IMG, IMG))))
    j_loc, j_ass = jax_state(weights[0]["params"], weights[0]["batch_stats"]), jax_state(weights[1]["params"])
    t_loc, t_ass = port_states(weights)
    init = {k: v.clone() for k, v in t_loc.model.state_dict().items()}
    config = AlternatingConfig(image_size=Size(IMG, IMG))
    rng = np.random.default_rng(0)
    records = []
    for step in range(2):
        batch = make_batch(rng)
        pre = (copy.deepcopy(t_loc.model), copy.deepcopy(t_ass.model))
        j_loc, j_ass, j_metrics = body(j_loc, j_ass, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.key(step))
        t_loc, t_ass, t_metrics = alternating_step(t_loc, t_ass, to_torch(batch), None, config)
        records.append({
            "batch": batch, "pre": pre,
            "metrics": (t_metrics, j_metrics),
            "loc": ({k: v.clone() for k, v in t_loc.model.state_dict().items()},
                    jax_localizer_sd(t_loc.model, j_loc)),
            "ass": ({k: v.clone() for k, v in t_ass.model.state_dict().items()},
                    bridge.assessor_state_dict(t_ass.model, j_ass.params)),
            "mu": ({n: t_loc.optimizer.state[p]["mu"].clone() for n, p in t_loc.model.named_parameters()},
                   jax_mu(j_loc)),
            "grad": {n: p.grad.clone() for n, p in t_loc.model.named_parameters()},
        })
    return {"init": init, "records": records, "steps": (t_loc.step, t_ass.step, int(j_loc.step))}


def _check_common(record):
    assert_metrics_close(*record["metrics"])
    got, want = record["ass"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    got, want = record["loc"]
    for k in want:
        if "running" in k:
            assert_rel(got[k], want[k], 1e-5, k)


def test_one_alternating_step_matches_jax(two_steps):
    record = two_steps["records"][0]
    _check_common(record)
    got, want = record["loc"]
    for k in want:
        if "running" not in k and "num_batches" not in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    # behind the zero head the backbone gets an exact zero gradient and
    # does not move; the head does
    init = two_steps["init"]
    conv = "feature_extractor.BasicStage_2.BasicB_0.ConvBN_1.Conv_0.weight"
    assert torch.equal(got[conv], init[conv])
    assert not torch.equal(got["param_predictor.weight"], init["param_predictor.weight"])
    assert float(record["grad"][conv].abs().max()) == 0.0


def test_two_alternating_steps_match_jax(two_steps):
    assert two_steps["steps"] == (2, 2, 2)
    record = two_steps["records"][1]
    _check_common(record)
    mu_got, mu_want = record["mu"]
    got, want = record["loc"]
    prev = two_steps["records"][0]["loc"][0]
    moved = 0
    for path, value in mu_want.items():
        key, mu_j = _torch_leaf(path, np.asarray(value))
        assert_rel(mu_got[key], mu_j, 3e-2, key)
        delta = np.abs(got[key].numpy() - want[key].numpy())
        sure = np.abs(mu_j) >= 0.1 * np.abs(mu_j).max()
        assert delta[sure].max(initial=0.0) <= 1e-6, key
        assert delta.max() <= 2 * LR, key
        moved += int((got[key] != prev[key]).sum())
    assert moved > 0.9 * sum(v.size for v in mu_want.values())  # the backbone trains


def _localizer_loss_f64_jax(params, batch_stats, images):
    jl = jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG),
                           dtype=jnp.float64, norm_dtype=jnp.float64)
    _, ja = jax_models()
    (rois, theta), _ = jl.apply({"params": params["loc"], "batch_stats": batch_stats}, images,
                                train=True, mutable=["batch_stats"])
    y = ja.apply({"params": params["ass"]}, rois.astype(jnp.float64))
    corners = jgeo.theta_corners(theta)
    return (jnp.mean(jnp.square(y - 1.0)) + jlosses.direction_loss(corners, JSize(IMG, IMG))
            + jlosses.out_of_image_loss(corners))


def to_flax(state_dict, template, dtype_of):
    """A port ``state_dict`` as flax variables shaped like ``template``
    (the bridge's layout rules, inverted)."""
    out = {}
    for path, old in bridge.flatten_variables(template).items():
        value = state_dict[_torch_leaf(path, old)[0]].detach().numpy()
        if path.endswith("kernel"):
            value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
        node = out
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(value, dtype_of(path))
    return out


def test_step_two_localizer_gradient_matches_jax_in_float64(weights, two_steps):
    """The gradient that step 2 applies, at the parameters that step 1
    left: JAX in float64 against the port's modules in float64 (the
    general sampler, the same function at these theta), then the port's
    float32 gradient against that."""
    record = two_steps["records"][1]
    loc, ass = (copy.deepcopy(m).double() for m in record["pre"])
    x = torch.from_numpy(record["batch"]["unlabeled"]).double() / 255.0
    loc.train()
    h = loc.feature_extractor((x * 255.0 - loc.mean.double()).permute(0, 3, 1, 2)).mean(dim=(2, 3))
    theta = rotation_dropout(loc.param_predictor(h).reshape(-1, 2, 3), 0.0)
    rois = stn.sample_grid(x, stn.affine_grid(theta, Size(CROP, CROP)))
    corners = geometry.theta_corners(theta)
    loss = (torch.mean(torch.square(ass(rois) - 1.0)) + losses.direction_loss(corners, Size(IMG, IMG))
            + losses.out_of_image_loss(corners))
    loss.backward()

    pre_loc, pre_ass = (m.state_dict() for m in record["pre"])
    with jax.enable_x64(True):
        def dtype_of(path):  # the JAX head computes in float32
            return jnp.float32 if "param_predictor" in path else jnp.float64

        params = {"loc": to_flax(pre_loc, weights[0]["params"], dtype_of),
                  "ass": to_flax(pre_ass, weights[1]["params"], dtype_of)}
        stats = to_flax(pre_loc, weights[0]["batch_stats"], dtype_of)
        grads = jax.grad(_localizer_loss_f64_jax)(params, stats, jnp.asarray(x.numpy()))["loc"]
        jax64 = dict(_torch_leaf(p, np.asarray(g)) for p, g in bridge.flatten_variables(grads).items())
    for name, p in loc.named_parameters():
        # the head's gradient is only as exact as JAX's float32 head
        assert_rel(p.grad.numpy(), jax64[name], 1e-4 if "param_predictor" in name else 1e-5, name)
        assert_rel(record["grad"][name].double().numpy(), jax64[name], 1e-4, name)


def test_freeze_assessor_reports_loss_without_update(weights):
    loc, ass = port_states(weights)
    before = {k: v.clone() for k, v in ass.model.state_dict().items()}
    batch = to_torch(make_batch(np.random.default_rng(1)))
    loc, ass, metrics = alternating_step(
        loc, ass, batch, None, AlternatingConfig(image_size=Size(IMG, IMG), freeze_assessor=True))
    for k, v in ass.model.state_dict().items():
        assert torch.equal(v, before[k])
    assert ass.step == 0 and loc.step == 1
    with torch.no_grad():
        y = ass.model(batch["real"].float() * (1.0 / 255.0))
    np.testing.assert_allclose(float(metrics["loss_dis"]),
                               float(torch.mean((y - batch["labels"]) ** 2)), rtol=1e-6)
    assert np.isfinite(float(metrics["loss_localizer"]))


def test_assessor_ema_with_delayed_start(weights):
    """Before ``assessor_ema_start`` the shadow equals the live parameters
    exactly; from it on it trails them by d·e + (1 - d)·p; the EMA copy
    scores the localizer."""
    loc, ass = port_states(weights)
    ass = ass.with_ema()
    assert all(e is not p for e, p in zip(ass.ema.parameters(), ass.model.parameters()))
    config = AlternatingConfig(image_size=Size(IMG, IMG), assessor_ema=0.9, assessor_ema_start=3)
    rng = np.random.default_rng(2)
    for step in range(4):
        ema_before = [e.clone() for e in ass.ema.parameters()]
        loc, ass, _ = alternating_step(loc, ass, to_torch(make_batch(rng)), None, config)
        live = list(ass.model.parameters())
        ema = list(ass.ema.parameters())
        if ass.step < 3:
            assert all(torch.equal(e, p) for e, p in zip(ema, live)), step
        else:
            for e, p, e0 in zip(ema, live, ema_before):
                torch.testing.assert_close(e, 0.9 * e0 + 0.1 * p.detach(), rtol=1e-6, atol=1e-7)
    assert not all(torch.equal(e, p) for e, p in zip(ass.ema.parameters(), ass.model.parameters()))

    # scoring goes through the EMA copy: a localizer step with a live
    # assessor that differs gives the EMA's y_fake
    scored = copy.deepcopy(ass)
    with torch.no_grad():
        for p in scored.model.parameters():
            p.add_(1.0)
    batch = to_torch(make_batch(rng))
    _, _, m_ema = alternating_step(copy.deepcopy(loc), scored, batch, None, config)
    _, _, m_ref = alternating_step(copy.deepcopy(loc), copy.deepcopy(ass), batch, None, config)
    np.testing.assert_allclose(float(m_ema["y_fake_mean"]), float(m_ref["y_fake_mean"]), rtol=1e-6)


def test_augment_reference_is_not_ported(weights):
    """``augment_reference`` was refused until ``data/device_augment.py``
    was ported; now it jitters the assessor's crops only: the localizer's
    loss is unchanged and the assessor's is not (the augmentation itself
    is held to JAX in ``test_torch_supervised.py``)."""
    batch = to_torch(make_batch(np.random.default_rng(3)))
    metrics = {}
    for augment in (False, True):
        loc, ass = port_states(weights)
        _, _, metrics[augment] = alternating_step(
            loc, ass, batch, torch.Generator().manual_seed(0),
            AlternatingConfig(image_size=Size(IMG, IMG), augment_reference=augment))
    assert float(metrics[True]["loss_localizer"]) == float(metrics[False]["loss_localizer"])
    assert float(metrics[True]["loss_dis"]) != float(metrics[False]["loss_dis"])


def test_eval_step_matches_inference_forward(weights):
    loc, _ = port_states(weights)
    loc.model.train()
    images = torch.from_numpy(make_batch(np.random.default_rng(4))["unlabeled"])
    theta = make_eval_step()(loc, images)
    assert loc.model.training
    with torch.no_grad():
        _, want = loc.model.eval()(images.float() * (1.0 / 255.0))
    torch.testing.assert_close(theta, want, rtol=0, atol=0)


# -- device data and the pooled step -------------------------------------------
@pytest.mark.parametrize("n,batch,seed", [(48, 8, 0), (24, 8, 1), (10, 3, 7)])
def test_index_sampler_matches_jax_exactly(n, batch, seed):
    ours = device_data.IndexSampler(n, batch, seed=seed).epochs()
    theirs = jdata.IndexSampler(n, batch, seed=seed).epochs()
    for _ in range(25):
        np.testing.assert_array_equal(next(ours), next(theirs))


def _pools(seed=0):
    gen = np.random.default_rng(seed)
    return {
        "unlabeled": {"unlabeled": gen.integers(0, 256, (POOL_SCENES, IMG, IMG, 3), dtype=np.uint8)},
        "reference": {
            "real": gen.integers(0, 256, (POOL_CROPS, CROP, CROP, 3), dtype=np.uint8),
            "labels": gen.uniform(size=(POOL_CROPS, 1)).astype(np.float32),
        },
    }


def test_device_chunks_carry_jax_index_streams():
    groups = _pools()
    chunks = device_data.device_chunk_batches(groups, BATCH, 3, seed=5, device="cpu")
    samplers = {g: jdata.IndexSampler(len(next(iter(t.values()))), BATCH, seed=5 + j).epochs()
                for j, (g, t) in enumerate(groups.items())}
    for _ in range(4):
        chunk = next(chunks)
        assert chunk["pools"]["reference"]["real"].dtype == torch.uint8
        for g in groups:
            want = np.stack([next(samplers[g]) for _ in range(3)])
            np.testing.assert_array_equal(chunk["idx"][g].numpy(), want)
    # a refresh every 0 chunks never calls its factory: the same streams
    def factory(generation):
        raise AssertionError("called")

    refreshed = device_data.device_chunk_batches(groups, BATCH, 3, seed=5, device="cpu",
                                                 refresh={"reference": (factory, 0)})
    samplers = {g: jdata.IndexSampler(len(next(iter(t.values()))), BATCH, seed=5 + j).epochs()
                for j, (g, t) in enumerate(groups.items())}
    for _ in range(4):
        chunk = next(refreshed)
        for g in groups:
            np.testing.assert_array_equal(chunk["idx"][g].numpy(), np.stack([next(samplers[g]) for _ in range(3)]))
    refreshed.close()


def test_pooled_chunk_matches_jax(weights):
    """One chunk of K = 3 steps against ``make_pooled_train_step`` on the
    same pools and index streams. Metrics are averages over the 3 steps;
    step 3 already feels step 2's Adam steps in opposite directions (see
    the module docstring), so they are held to 1e-3 relative, and the
    head's bias to 2e-3 absolute, as ``tests/test_train_step.py`` holds
    the JAX pooled step to its own replay."""
    K = 3
    groups = _pools(1)
    chunk = next(device_data.device_chunk_batches(groups, BATCH, K, seed=0, device="cpu"))
    loc, ass = port_states(weights)
    loc, ass, metrics = pooled_step(loc, ass, chunk, None, K, AlternatingConfig(image_size=Size(IMG, IMG)))
    assert loc.step == K and ass.step == K

    jl, ja = jax_models()
    step = jsteps.make_pooled_train_step(
        jsteps.alternating_step_body(jl, ja, jsteps.AlternatingConfig(image_size=JSize(IMG, IMG))), K)
    j_chunk = {
        "pools": jax.tree.map(jnp.asarray, groups),
        "idx": {g: jnp.asarray(chunk["idx"][g].numpy().astype(np.int32)) for g in groups},
    }
    j_loc, j_ass, j_metrics = step(jax_state(weights[0]["params"], weights[0]["batch_stats"]),
                                   jax_state(weights[1]["params"]), j_chunk, jax.random.key(0))
    assert int(j_loc.step) == K
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(loc.model.param_predictor.bias.detach().numpy(),
                               np.asarray(j_loc.params["param_predictor"]["bias"]), atol=2e-3)
    with pytest.raises(ValueError, match="steps_per_call"):
        pooled_step(loc, ass, chunk, None, K + 1)


# -- the trainer ------------------------------------------------------------------
def test_trainer_intervals_and_schedules_match_jax():
    for prev, cur, every in ((0, 4, 4), (4, 7, 4), (7, 8, 4), (5, 6, 3)):
        assert _crossed(prev, cur, every) == j_crossed(prev, cur, every)
    for args in ((9, 12), (10, 19), (19, 20), (0, 0)):
        assert Hook(lambda t, i: None, every=10).due_span(*args) == \
            JHook(lambda t, i: None, every=10).due_span(*args)
    from loans_tpu.train.loop import multiplicative_lr_decay as jdecay, two_state_lr_shifter as jshift
    for it in (0, 5, 10, 15, 20, 30):
        assert two_state_lr_shifter(1e-3, 1e-4, 10, 20)(it) == jshift(1e-3, 1e-4, 10, 20)(it)
        assert multiplicative_lr_decay(0.5, 10, 1e-3)(it) == jdecay(0.5, 10, 1e-3)(it)


def test_trainer_run_snapshots_restore_and_serve(weights, tmp_path):
    """Six iterations as two pooled chunks of 3 on the CPU: a log with the
    config in its first entry, training snapshots that restore exactly,
    and a log dir that ``LocalizerInference`` serves."""
    log_dir = str(tmp_path / "run")
    checkpoint.save_manifest(log_dir, MANIFEST)
    loc, ass = port_states(weights)
    K = 3
    chunks = device_data.device_chunk_batches(_pools(2), BATCH, K, seed=0, device="cpu")
    config = AlternatingConfig(image_size=Size(IMG, IMG))
    trainer = Trainer(
        functools.partial(pooled_step, steps_per_call=K, config=config),
        loc, ass, chunks, log_dir, max_iterations=6,
        generator=torch.Generator().manual_seed(0), config={"batch_size": BATCH},
        snapshot_interval=3, log_interval=3, steps_per_call=K,
        lr_schedule=two_state_lr_shifter(LR, 5e-4, 3, 6), print_report=False,
        control=CommandChannel(log_dir),  # no command: no effect
    )
    loc, ass = trainer.run()
    assert trainer.iteration == 6 and loc.step == 6 and ass.step == 6
    assert loc.learning_rate == pytest.approx(5e-4)

    log = MetricsLog.read(log_dir)
    assert [e["iteration"] for e in log] == [3, 6]
    assert log[0]["batch_size"] == BATCH and "batch_size" not in log[1]
    for entry in log:
        assert {"loss_localizer", "loss_dis", "y_fake_mean", "y_real_mean", "lr",
                "images_per_sec", "elapsed_time"} <= set(entry)
        assert np.isfinite(entry["loss_localizer"]) and entry["images_per_sec"] > 0
    with open(os.path.join(log_dir, "log")) as f:
        assert json.load(f) == log
    snaps = checkpoint.list_snapshots(log_dir, "Localizer_")
    assert [it for it, _ in snaps] == [3, 6]
    assert [it for it, _ in checkpoint.list_snapshots(log_dir, "ResnetAssessor_")] == [3, 6]

    fresh_loc, fresh_ass = port_states(weights)
    checkpoint.restore_state(snaps[-1][1], fresh_loc)
    checkpoint.restore_state(os.path.join(log_dir, "ResnetAssessor_6.pt"), fresh_ass)
    assert fresh_loc.step == 6 and fresh_ass.step == 6
    for (k, v), w in zip(loc.model.state_dict().items(), fresh_loc.model.state_dict().values()):
        assert torch.equal(v, w), k
    p_old, p_new = next(loc.model.parameters()), next(fresh_loc.model.parameters())
    assert torch.equal(loc.optimizer.state[p_old]["nu_max"], fresh_loc.optimizer.state[p_new]["nu_max"])
    assert fresh_loc.optimizer.param_groups[0]["step"] == 6
    assert fresh_loc.learning_rate == pytest.approx(5e-4)
    with pytest.raises(ValueError, match="params-only"):
        path = checkpoint.save_params(os.path.join(log_dir, "x.pt"), loc.model.state_dict())
        checkpoint.restore_state(path, fresh_loc)

    trainer2 = Trainer(None, fresh_loc, fresh_ass, iter(()), str(tmp_path / "other"), 6)
    with pytest.raises(SystemExit, match="TOTAL"):
        trainer2.resume(snaps[-1][1])

    inf = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    frames = np.random.default_rng(9).uniform(size=(3, IMG, IMG, 3)).astype(np.float32)
    boxes, rois, scores, _ = inf.localize_batch(frames)
    assert boxes.shape == (3, 1, 4) and rois.shape == (3, CROP, CROP, 3)
    assert np.isfinite(boxes).all() and ((scores > 0) & (scores < 1)).all()
    theta = make_eval_step()(loc, torch.from_numpy(frames))
    want = geometry.corners_to_aabb(geometry.theta_corners(theta), Size(IMG, IMG), clip=True)
    np.testing.assert_allclose(boxes[:, 0], want.numpy(), atol=1e-4)
