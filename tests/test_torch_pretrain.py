"""Backbone pretraining in the port against the JAX package and its tool
``tools/pretrain_backbone.py``: the classifier head of ``ResNet``, the
labeled scene pool, one classifier step and the CLI on the CPU.

Weights are drawn with numpy from a seed (``test_torch_models.
random_variables``) and carried across by ``loans_tpu_torch.bridge``.

Tolerances: eval-mode logits 1e-4 relative to the largest logit, as the
models' features (``test_torch_models.py``: float32 convolutions summed in
another order, growing with depth). Train-mode logits and the updated
BatchNorm running statistics 1e-3 relative to each tensor's largest entry:
flax takes the batch variance as E[x²] - E[x]², which cancels digits
where a channel's mean is large against its spread (at R-50, JAX's
train-mode logits lie 2.2e-4 of the largest from a float64 forward of the
same weights and its statistics 1.6e-4, the port's 6.1e-5 and 3.4e-5;
at R-18 all under 3.4e-6). One step (R-18): the loss 1e-5 relative, the
BatchNorm statistics 1e-5 (R-18's error above); the parameters after the Adam update within 2 lr + 1e-7 of
JAX's everywhere (Adam moves a weight by about lr in its gradient's sign,
which a gradient within float32 error of 0 may flip), within 1e-6 where
the gradient's first moment is at least a tenth of its tensor's largest,
and within 1e-6 on 99% of the entries (``test_torch_ssd_device.py``'s
rule). bf16 logits within 5e-2 of the largest (a bfloat16 mantissa of 8
bits, summed through 18 layers in another order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from loans_tpu.models.localizer import IMAGENET_MEAN_RGB as JAX_MEAN
from loans_tpu.models.resnet import ResNet as JaxResNet
from loans_tpu.train import state as jstate
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import import_resnet50, pretrain_backbone
from loans_tpu_torch.models.resnet import ResNet, set_dtypes
from loans_tpu_torch.train import checkpoint, create_train_state

sys.path.insert(0, "tools")
sys.path.insert(0, "tests")

import pretrain_backbone as jax_tool  # noqa: E402
from test_torch_models import random_variables  # noqa: E402

IMG, CLASSES, LR = 64, 8, 1e-3

torch.set_num_threads(min(4, torch.get_num_threads()))


def jax_variables(n_layers, seed, dtype=jnp.float32):
    jm = JaxResNet(n_layers, class_labels=CLASSES, dtype=dtype, norm_dtype=dtype)
    return jm, random_variables(jm, jnp.zeros((2, IMG, IMG, 3)), seed=seed, train=False)


def port_model(n_layers, variables):
    model = ResNet(n_layers, class_labels=CLASSES)
    model.load_state_dict(bridge.to_state_dict(model, variables["params"], variables["batch_stats"]))
    return model


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-12), f"{what}: max abs err {err}"


def scenes(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8), rng.integers(0, CLASSES, n).astype(np.int32)


# -- the classifier head -------------------------------------------------------
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("n_layers", [18, 50])
def test_classifier_logits_match_jax(n_layers, train):
    """``ResNet(n, class_labels=8)``: the global mean of res5 through
    ``Dense_0``; in train mode the updated BatchNorm statistics too."""
    jm, v = jax_variables(n_layers, seed=n_layers)
    x = np.random.default_rng(1).uniform(-100, 150, (2, IMG, IMG, 3)).astype(np.float32)
    model = port_model(n_layers, v).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, CLASSES)
    if not train:
        assert_rel(got.numpy(), jm.apply(v, jnp.asarray(x), train=False), 1e-4, "logits")
        return
    want, updates = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert_rel(got.numpy(), want, 1e-3, "logits")
    _, stats = bridge.from_state_dict(model.state_dict())
    flat_got, flat_want = bridge.flatten_variables(stats), bridge.flatten_variables(updates["batch_stats"])
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        assert_rel(flat_got[k], flat_want[k], 1e-3, k)


def test_classifier_head_init_is_flax_dense():
    """``Dense_0`` starts as flax's ``Dense``: a zero bias and a lecun-normal
    kernel (std sqrt(1/fan_in), truncated at two deviations)."""
    torch.manual_seed(0)
    dense = ResNet(50, class_labels=64).Dense_0
    w = dense.weight.detach()
    assert w.shape == (64, 2048) and not dense.bias.any()
    assert abs(float(w.std()) - np.sqrt(1 / 2048)) < 0.05 * np.sqrt(1 / 2048)
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / 2048) / 0.87962566103423978


def test_classifier_logits_bf16_match_jax():
    """``--bf16``: convolutions, BatchNorm outputs and ``Dense_0`` in
    bfloat16 (``set_dtypes``), as the JAX tool's ``dtype=norm_dtype=bf16``."""
    jm, v = jax_variables(18, seed=3, dtype=jnp.bfloat16)
    x = np.random.default_rng(2).uniform(-100, 150, (2, IMG, IMG, 3)).astype(np.float32)
    model = set_dtypes(port_model(18, v), torch.bfloat16, torch.bfloat16).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and model.Dense_0.weight.dtype == torch.float32
    want = jm.apply(v, jnp.asarray(x, jnp.bfloat16), train=False)
    assert_rel(got.float().numpy(), np.asarray(want, np.float32), 5e-2, "bf16 logits")


# -- the labeled scene pool ----------------------------------------------------
def test_scene_pool_is_the_jax_tools():
    """The pinned stamp draws no stamp, so the scenes and labels are the JAX
    tool's (Pillow there, ``data.image_ops`` here) bit for bit."""
    got = pretrain_backbone.make_scene_pool(6, 4, asset_seed=3, seed=5, image_size=(IMG, IMG))
    want = jax_tool.make_scene_pool(6, 4, asset_seed=3, seed=5, image_size=(IMG, IMG))
    assert got["images"].shape == (6, IMG, IMG, 3) and got["images"].dtype == np.uint8
    assert got["labels"].dtype == np.int32 and len(set(got["labels"].tolist())) > 1
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["images"], want["images"])


# -- one classifier step -------------------------------------------------------
def jax_step(jm, variables, images, labels, flip):
    """The JAX tool's body (``tools/pretrain_backbone.py:177-203``) with the
    flip mask given: flax ResNet, optax cross-entropy, amsgrad."""
    tx = jstate.adam_amsgrad(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                              opt_state=tx.init(params), tx=tx)
    x = jnp.asarray(images).astype(jnp.float32) - jnp.asarray(JAX_MEAN, jnp.float32)
    x = jnp.where(jnp.asarray(flip)[:, None, None, None], x[:, :, ::-1, :], x)
    y = jnp.asarray(labels)

    def loss_fn(params):
        logits, new = jm.apply({"params": params, "batch_stats": state.batch_stats}, x, train=True,
                               mutable=["batch_stats"])
        logits = logits.astype(jnp.float32)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, (new["batch_stats"], jnp.mean(jnp.argmax(logits, -1) == y))

    (loss, (stats, acc)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    state = state.apply_gradients(grads, new_batch_stats=stats)
    return state, float(loss), float(acc)


def test_one_classifier_step_matches_jax():
    """R-18, 64², batch 4, JAX's flip mask applied by the port: loss,
    accuracy, parameters and BatchNorm statistics after the update."""
    jm, v = jax_variables(18, seed=7)
    images, labels = scenes(8, 4)
    flip = np.array([True, False, True, False])
    want_state, want_loss, want_acc = jax_step(jm, v, images, labels, flip)
    model = port_model(18, v)
    state = create_train_state(model, LR)
    state, metrics = pretrain_backbone.classifier_step(
        state, {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}, torch.from_numpy(flip))
    assert state.step == 1
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    assert float(metrics["acc"]) == want_acc
    want = bridge.to_state_dict(model, want_state.params, want_state.batch_stats)
    start = bridge.to_state_dict(model, v["params"], v["batch_stats"])
    mu = {n: state.optimizer.state[p]["mu"] for n, p in model.named_parameters()}
    close = total = 0
    for key, p in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if "running" in key:
            assert_rel(p.numpy(), want[key].numpy(), 1e-5, key)
            continue
        diff = np.abs(p.numpy() - want[key].numpy())
        assert diff.max() <= 2 * LR + 1e-7, key
        m = np.abs(mu[key].numpy())
        assert diff[m >= 0.1 * m.max()].max() <= 1e-6, key
        assert not torch.equal(p, start[key]), key
        close, total = close + int((diff <= 1e-6).sum()), total + diff.size
    assert close >= 0.99 * total


def test_flips_are_drawn_apart_from_their_application():
    """``classifier_body`` draws the mask on its generator, then applies it
    through ``classifier_step``: the same generator state gives the same
    update as the step with ``draw_flips``' mask."""
    jm, v = jax_variables(18, seed=9)
    images, labels = scenes(10, 4)
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    flips = pretrain_backbone.draw_flips(torch.Generator().manual_seed(3), 4)
    assert flips.dtype == torch.bool and flips.shape == (4,)
    a, b = (create_train_state(port_model(18, v), LR) for _ in range(2))
    a, _, metrics_a = pretrain_backbone.classifier_body(a, None, batch, torch.Generator().manual_seed(3))
    b, metrics_b = pretrain_backbone.classifier_step(b, batch, flips)
    assert float(metrics_a["loss"]) == float(metrics_b["loss"])
    for (k, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), k


# -- the CLI on the CPU ----------------------------------------------------------
def test_pretrain_cli_on_cpu(tmp_path):
    """2 iterations at 64², pool 8, batch 4: a log entry, the validation
    accuracy, and a torchvision file that imports into the Localizer."""
    out = tmp_path / "backbone.pth"
    result = pretrain_backbone.main([
        "--out", str(out), "--classes", "4", "--pool", "8", "--val-pool", "4", "--iterations", "2",
        "--batch-size", "4", "--steps-per-call", "2", "--log-interval", "2", "--image-size", str(IMG),
        "--device", "cpu"])
    assert [e["iteration"] for e in result["log"]] == [2]
    assert np.isfinite(result["log"][0]["loss"]) and 0 <= result["log"][0]["acc"] <= 1
    assert 0 <= result["val_acc"] <= 1 and result["tensors"] == 318
    sd = torch.load(out, weights_only=True)
    assert len(sd) == 318 and "fc.weight" not in sd and int(sd["bn1.num_batches_tracked"]) == 0
    pt = import_resnet50.main([str(out), str(tmp_path / "pre.pt"), "--verify", "--device", "cpu"])
    imported = checkpoint.load_params(pt)
    assert torch.equal(imported["feature_extractor.Conv_0.weight"], sd["conv1.weight"])
