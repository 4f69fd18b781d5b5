"""The supervised step, the reference crops' augmentation, bf16, the
partial restore and the command channel of the port against the JAX
package.

Models at a small size (Localizer R-18 64²→16², ResnetAssessor ch 8,
batch 8), weights drawn with numpy from a seed and carried into the port
by ``bridge``. The JAX steps are ``supervised_step_body`` and
``alternating_step_body``, jitted.

Tolerances, with their reasons:

* supervised step, float32: metrics 1e-5 relative and parameters after
  step 1 1e-6 absolute, as ``test_torch_train.py`` holds the alternating
  step (float32 on both sides; behind the zero head only the head moves
  at step 1). After step 2, where Adam moves every backbone weight by
  about lr in its gradient's sign, parameters are held to 2·lr and the
  BatchNorm statistics to 1e-5 of each tensor's largest entry.
* augmentation: 1e-6 absolute (the same float32 operations on values in
  [0, 1]).
* bf16: the convolutions round every output to bfloat16 (8 significant
  bits, a relative step of 2^-8 = 3.9e-3), and PyTorch and XLA sum the
  products in another order before rounding, so an output lying near a
  rounding boundary takes the neighbouring bfloat16 value on one side;
  such flips pass through the network, and the two packages' bf16 results
  differ by about as much as either differs from float32 (R-18 pooled
  features: 2.9% of their largest against JAX's own 4.0% from float32).
  So the yardstick is JAX's own bf16 error, measured in the test against
  JAX in float32: theta and one alternating step's metrics are held to
  twice it (each metric at least 4e-3 relative, one bfloat16 step); the
  localizer's loss after its direction and out-of-image terms, which are
  linear in theta with large slopes, are taken out at each package's own
  theta (measured: the remaining MSE within the yardstick). The
  crop stays float32 in both packages: the port's crops are held to JAX's
  float32 crop at the port's theta, 1e-5 absolute.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables  # noqa: E402

from loans_tpu import models as jmodels
from loans_tpu.data import device_augment as jaugment
from loans_tpu.ops import geometry as jgeo
from loans_tpu.ops import losses as jlosses
from loans_tpu.ops import stn as jstn
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.train import control as jcontrol
from loans_tpu.train import state as jstate
from loans_tpu.train import steps as jsteps
from loans_tpu_torch import bridge, models
from loans_tpu_torch.data import device_augment
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.train import (
    AlternatingConfig,
    CommandChannel,
    Trainer,
    alternating_step,
    apply_commands,
    checkpoint,
    create_train_state,
    pooled_step,
    supervised_step,
)

IMG, CROP, BATCH, CH, LR = 64, 16, 8, 8, 1e-3
torch.set_num_threads(min(4, torch.get_num_threads()))


def jax_state(params, batch_stats=None):
    tx = jstate.adam_amsgrad(LR)
    params = jax.tree.map(jnp.asarray, params)
    return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(jnp.asarray, batch_stats or {}),
                             opt_state=tx.init(params), tx=tx)


def jax_localizer(**kw):
    return jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG), **kw)


def port_localizer(variables, **kw):
    loc = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG), **kw)
    loc.load_state_dict(bridge.localizer_state_dict(loc, variables["params"], variables["batch_stats"]))
    return loc


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rtol * scale, what


@pytest.fixture(scope="module")
def loc_variables():
    v = random_variables(jax_localizer(), jnp.zeros((2, IMG, IMG, 3)), seed=1, train=False)
    v["params"]["param_predictor"]["kernel"] = np.zeros_like(v["params"]["param_predictor"]["kernel"])
    return v


def supervised_batch(rng, n=BATCH):
    tl = rng.uniform(0, IMG / 2, (n, 2))
    gt = np.concatenate([tl, tl + rng.uniform(8, IMG / 2, (n, 2))], axis=1)[:, None, :].astype(np.float32)
    return (rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8), gt, np.zeros((n, 1), np.float32))


# -- the supervised step ---------------------------------------------------------
def test_two_supervised_steps_match_jax(loc_variables):
    config = jsteps.AlternatingConfig(image_size=JSize(IMG, IMG))
    body = jax.jit(jsteps.supervised_step_body(jax_localizer(), config))
    j_state = jax_state(loc_variables["params"], loc_variables["batch_stats"])
    state = create_train_state(port_localizer(loc_variables), LR)
    init = copy.deepcopy(state.model.state_dict())
    rng = np.random.default_rng(0)
    for step in range(2):
        batch = supervised_batch(rng)
        j_state, none, j_metrics = body(j_state, None, tuple(jnp.asarray(b) for b in batch), jax.random.key(step))
        state, t_none, metrics = supervised_step(
            state, None, tuple(torch.from_numpy(b) for b in batch), None, AlternatingConfig(image_size=Size(IMG, IMG)))
        assert none is None and t_none is None
        assert set(metrics) == set(j_metrics) == {"loss_localizer", "loss/box", "loss/iou"}
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5, err_msg=k)
        want = bridge.localizer_state_dict(state.model, j_state.params, j_state.batch_stats)
        got = state.model.state_dict()
        for k in want:
            if "num_batches" in k:
                continue
            if "running" in k:
                assert_rel(got[k], want[k], 1e-5, k)
            elif step == 0:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=2 * LR, err_msg=k)
        if step == 0:  # behind the zero head only the head moves
            conv = "feature_extractor.BasicStage_1.BasicB_0.ConvBN_0.Conv_0.weight"
            assert torch.equal(got[conv], init[conv])
            assert not torch.equal(got["param_predictor.bias"], init["param_predictor.bias"])
    assert state.step == 2 and int(j_state.step) == 2


def test_supervised_step_runs_no_crop(loc_variables, monkeypatch):
    """Only theta enters the loss, so the crop is never called."""
    from loans_tpu_torch.models import localizer as mloc

    def boom(*a, **k):
        raise AssertionError("the supervised step cropped")

    monkeypatch.setattr(mloc, "spatial_transform", boom)
    state = create_train_state(port_localizer(loc_variables), LR)
    batch = supervised_batch(np.random.default_rng(1))
    chunk = {"pools": {"train": {"images": torch.from_numpy(batch[0]), "boxes": torch.from_numpy(batch[1]),
                                 "scores": torch.from_numpy(batch[2])}},
             "idx": {"train": torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])}}
    state, none, metrics = pooled_step(state, None, chunk, None, steps_per_call=2,
                                       config=AlternatingConfig(image_size=Size(IMG, IMG)), body=supervised_step)
    assert none is None and state.step == 2
    assert all(np.isfinite(float(v)) for v in metrics.values())


# -- augmentation --------------------------------------------------------------
def test_augment_crops_matches_jax_with_explicit_draws():
    """JAX draws with its own keys; the same flips and jitter values, passed
    in explicitly, give the same images (C = 3 with saturation, C = 1
    without)."""
    rng = np.random.default_rng(2)
    for c in (3, 1):
        images = rng.uniform(size=(6, 5, 7, c)).astype(np.float32)
        flips = np.array([True, False, True, True, False, False])
        jitter = device_augment.Jitter(
            *(torch.from_numpy(rng.uniform(lo, hi, (6, 1, 1, 1)).astype(np.float32))
              for lo, hi in (device_augment.BRIGHTNESS, device_augment.CONTRAST, device_augment.SATURATION)))
        flipped = np.where(flips[:, None, None, None], images[:, :, ::-1, :], images)
        # JAX's photometric with its uniform draws replaced by these values
        mean = flipped.mean(axis=(1, 2, 3), keepdims=True)
        want = (flipped - mean) * jitter.contrast.numpy() + mean + jitter.brightness.numpy()
        if c == 3:
            gray = want.mean(axis=-1, keepdims=True)
            want = gray + (want - gray) * jitter.saturation.numpy()
        want = np.clip(want, 0.0, 1.0)
        got = device_augment.augment_crops(torch.from_numpy(images), flips=torch.from_numpy(flips), jitter=jitter)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        # the JAX function itself, on a key whose draws are read back
        key = jax.random.key(3)
        j_out = np.asarray(jaugment.augment_crops(key, jnp.asarray(images)))
        k_flip, k_photo = jax.random.split(key)
        j_flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (6, 1, 1, 1)))[:, 0, 0, 0]
        kb, kc, ks = jax.random.split(k_photo, 3)
        j_jitter = device_augment.Jitter(*(
            torch.from_numpy(np.array(jax.random.uniform(k, (6, 1, 1, 1), minval=lo, maxval=hi)))
            for k, (lo, hi) in zip((kb, kc, ks), (device_augment.BRIGHTNESS, device_augment.CONTRAST,
                                                  device_augment.SATURATION))))
        got = device_augment.augment_crops(torch.from_numpy(images), flips=torch.from_numpy(j_flips), jitter=j_jitter)
        np.testing.assert_allclose(got.numpy(), j_out, rtol=0, atol=1e-6)


def test_augment_draws_are_in_range_and_seeded():
    images = torch.rand(64, 4, 4, 3)
    a = device_augment.draw_jitter(torch.Generator().manual_seed(0), images)
    b = device_augment.draw_jitter(torch.Generator().manual_seed(0), images)
    for x, y, (lo, hi) in zip(a, b, (device_augment.BRIGHTNESS, device_augment.CONTRAST, device_augment.SATURATION)):
        assert torch.equal(x, y) and x.shape == (64, 1, 1, 1)
        assert float(x.min()) >= lo and float(x.max()) < hi
    flips = device_augment.draw_flips(torch.Generator().manual_seed(1), images)
    assert flips.dtype == torch.bool and 0 < int(flips.sum()) < 64


def test_alternating_step_augments_the_reference_crops(loc_variables):
    """``augment_reference`` changes only the assessor's input: the same
    step with the augmentation's draws replayed on the crops equals a step
    without it on the augmented crops."""
    ass_v = random_variables(jmodels.ResnetAssessor(ch=CH), jnp.zeros((2, CROP, CROP, 3)), seed=2)

    def states():
        ass = models.ResnetAssessor(ch=CH, in_size=Size(CROP, CROP))
        ass.load_state_dict(bridge.assessor_state_dict(ass, ass_v["params"]))
        return create_train_state(port_localizer(loc_variables), LR), create_train_state(ass, LR)

    rng = np.random.default_rng(4)
    batch = {"real": torch.from_numpy(rng.integers(0, 256, (BATCH, CROP, CROP, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.uniform(size=(BATCH, 1)).astype(np.float32)),
             "unlabeled": torch.from_numpy(rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8))}
    config = AlternatingConfig(image_size=Size(IMG, IMG), augment_reference=True)
    _, _, m_aug = alternating_step(*states(), batch, torch.Generator().manual_seed(9), config)
    real = batch["real"].float() * (1.0 / 255.0)
    replay = device_augment.augment_crops(real, torch.Generator().manual_seed(9))
    plain = dict(batch, real=replay)
    _, _, m_plain = alternating_step(*states(), plain, None, AlternatingConfig(image_size=Size(IMG, IMG)))
    for k in m_aug:
        assert float(m_aug[k]) == float(m_plain[k]), k
    _, _, m_none = alternating_step(*states(), batch, None, AlternatingConfig(image_size=Size(IMG, IMG)))
    assert float(m_none["loss_dis"]) != float(m_aug["loss_dis"])


# -- bf16 -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bf16_weights():
    loc = random_variables(jax_localizer(), jnp.zeros((2, IMG, IMG, 3)), seed=1, train=False, head_std=1e-2)
    ass = random_variables(jmodels.ResnetAssessor(ch=CH), jnp.zeros((2, CROP, CROP, 3)), seed=2)
    return loc, ass


@pytest.mark.parametrize("norm", ["bf16", "f32"])
def test_bf16_forward_and_step_match_jax(bf16_weights, norm):
    loc_v, ass_v = bf16_weights
    j_norm, t_norm = (jnp.bfloat16, torch.bfloat16) if norm == "bf16" else (jnp.float32, torch.float32)
    jl = jax_localizer(dtype=jnp.bfloat16, norm_dtype=j_norm)
    ja = jmodels.ResnetAssessor(ch=CH, dtype=jnp.bfloat16)

    def port_pair():
        ass = models.ResnetAssessor(ch=CH, in_size=Size(CROP, CROP), dtype=torch.bfloat16)
        ass.load_state_dict(bridge.assessor_state_dict(ass, ass_v["params"]))
        return port_localizer(loc_v, dtype=torch.bfloat16, norm_dtype=t_norm), ass

    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    xf = x.astype(np.float32) / 255.0
    (_, j_theta), _ = jl.apply(loc_v, jnp.asarray(xf), train=True, mutable=["batch_stats"])
    (_, f32_theta), _ = jax_localizer().apply(loc_v, jnp.asarray(xf), train=True, mutable=["batch_stats"])
    loc, ass = port_pair()
    seen = {"conv": set(), "norm": set()}

    def record(kind):
        return lambda module, inputs, out: seen[kind].add(out.dtype)

    for m in list(loc.modules()) + list(ass.modules()):
        if isinstance(m, models.resnet.Conv2d):
            m.register_forward_hook(record("conv"))
        elif isinstance(m, models.resnet.BatchNorm2d):
            m.register_forward_hook(record("norm"))
    rois, theta = loc.train()(torch.from_numpy(xf))
    assert ass(rois).dtype == torch.float32
    # the dtypes take effect: every convolution of both models computes in
    # bfloat16, every BatchNorm gives norm_dtype
    assert seen == {"conv": {torch.bfloat16}, "norm": {t_norm}}
    assert theta.dtype == torch.float32 and rois.dtype == torch.float32  # the crop stays float32
    j_theta, f32_theta = np.asarray(j_theta), np.asarray(f32_theta)
    assert float(np.ptp(j_theta[:, 0, 2])) > 0.05  # theta varies between images
    bf16_error = float(np.abs(j_theta - f32_theta).max())  # JAX's own bf16 rounding
    assert 1e-3 < bf16_error < 0.1
    assert float(np.abs(theta.detach().numpy() - j_theta).max()) <= 2 * bf16_error
    # and the port really rounds: a port that ran in float32 would pass the
    # bound above, but not this one against its own float32 theta
    _, port_f32_theta = port_localizer(loc_v).train()(torch.from_numpy(xf))
    assert float((theta - port_f32_theta).abs().max().detach()) > bf16_error / 4
    want_rois = jstn.spatial_transform(jnp.asarray(xf), jnp.asarray(theta.detach().numpy()),
                                       JSize(CROP, CROP), method="separable")
    np.testing.assert_allclose(rois.detach().numpy(), np.asarray(want_rois), rtol=0, atol=1e-5)

    config = jsteps.AlternatingConfig(image_size=JSize(IMG, IMG))
    batch = {"real": rng.integers(0, 256, (BATCH, CROP, CROP, 3), dtype=np.uint8),
             "labels": rng.uniform(size=(BATCH, 1)).astype(np.float32), "unlabeled": x}
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    runs = {}
    for name, (jlm, jam) in {"bf16": (jl, ja), "f32": (jax_localizer(), jmodels.ResnetAssessor(ch=CH))}.items():
        body = jax.jit(jsteps.alternating_step_body(jlm, jam, config))
        runs[name] = body(jax_state(loc_v["params"], loc_v["batch_stats"]), jax_state(ass_v["params"]),
                          j_batch, jax.random.key(0))[2]
    loc, ass = port_pair()
    _, _, metrics = alternating_step(create_train_state(loc, LR), create_train_state(ass, LR),
                                     {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                                     AlternatingConfig(image_size=Size(IMG, IMG)))
    # the localizer's loss is mostly its regularizers, linear in theta with
    # large slopes (a sum over the batch): it may differ by what theta's
    # difference moves them, plus the bf16 yardstick on the rest
    def regularizers(t):
        corners = jgeo.theta_corners(jnp.asarray(t))
        return float(jlosses.direction_loss(corners, JSize(IMG, IMG)) + jlosses.out_of_image_loss(corners))

    reg = {"port": regularizers(theta.detach().numpy()), "bf16": regularizers(j_theta),
           "f32": regularizers(f32_theta)}
    for k in metrics:
        got, want, f32 = float(metrics[k]), float(runs["bf16"][k]), float(runs["f32"][k])
        if k == "loss_localizer":  # compare the MSE parts
            got, want, f32 = got - reg["port"], want - reg["bf16"], f32 - reg["f32"]
        assert abs(got - want) <= max(2 * abs(want - f32), 4e-3 * abs(want)), k
    for p in list(loc.parameters()) + list(ass.parameters()):
        assert p.dtype == torch.float32  # parameters stay float32


# -- restore and control ----------------------------------------------------------
def test_restore_params_skips_the_head(tmp_path):
    torch.manual_seed(0)
    src = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG))
    with torch.no_grad():
        src.param_predictor.weight.normal_()
        for buf in src.buffers():
            buf.add_(1)
    path = checkpoint.save_params(str(tmp_path / "Localizer_3.pt"), src.state_dict())
    torch.manual_seed(1)
    dst = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG))
    head = {k: v.clone() for k, v in dst.state_dict().items() if k.startswith("param_predictor")}
    taken = checkpoint.restore_params(path, dst, skip_prefixes=("param_predictor",))
    got, want = dst.state_dict(), src.state_dict()
    for k, v in got.items():
        if k.startswith("param_predictor"):
            assert torch.equal(v, head[k]) and k not in taken
        else:
            assert torch.equal(v, want[k]) and k in taken
    # a training snapshot loads too; a shape that does not fit keeps the
    # model's own value, as the JAX package's strict=False load
    state = create_train_state(src, LR)
    training = checkpoint.save_state(str(tmp_path / "Localizer_4.pt"), state)
    other = models.Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(96, 96))  # adds res6
    keep = {k: v.clone() for k, v in other.state_dict().items() if k.startswith("res6")}
    taken = checkpoint.restore_params(training, other, skip_prefixes=("param_predictor/",))
    assert "param_predictor.weight" in taken  # '/'-joined prefix of another module
    assert all(torch.equal(other.state_dict()[k], v) for k, v in keep.items())


class Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


def test_apply_commands_matches_jax(capsys):
    commands = ["shiftlr 0.5", "setlr 2e-4", "SETLR 1e-3", "enablebboxvis", "echo hello", "bogus", "", "quit"]
    got, want = Recorder(), Recorder()
    apply_commands(commands, got)
    out_port = capsys.readouterr().out
    jcontrol.apply_commands(commands, want)
    assert got.calls == want.calls
    assert out_port == capsys.readouterr().out


def test_command_channel_drives_the_trainer(tmp_path):
    """A control file's lines reach the trainer at the next step-call
    boundary: the learning rate changes for both states, ``quit`` ends
    the run early, and consumed lines are not replayed."""
    log_dir = str(tmp_path)
    loc = create_train_state(torch.nn.Linear(2, 1), LR)
    ass = create_train_state(torch.nn.Linear(2, 1), LR)
    calls = []

    def step(loc_state, ass_state, batch, generator):
        calls.append(loc_state.learning_rate)
        if len(calls) == 2:
            with open(os.path.join(log_dir, "control"), "a") as f:
                f.write("setlr 0.5\nshiftlr 0.1\n")
        if len(calls) == 4:
            with open(os.path.join(log_dir, "control"), "a") as f:
                f.write("quit\n")
        loc_state.step += 1
        return loc_state, ass_state, {"loss": torch.tensor(0.0)}

    channel = CommandChannel(log_dir)
    trainer = Trainer(step, loc, ass, iter([{"x": torch.zeros(1, 2)}] * 100), log_dir, max_iterations=100,
                      log_interval=0, control=channel, print_report=False)
    trainer.run()
    assert calls == [LR, LR, 0.05, 0.05]
    assert trainer.iteration == 4 and ass.learning_rate == pytest.approx(0.05)
    assert channel.drain() == []
