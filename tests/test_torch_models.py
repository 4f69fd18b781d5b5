"""Models of the PyTorch port against the JAX package, from one set of
weights carried across by ``loans_tpu_torch.bridge``.

Weights are drawn with numpy from a seed in the shapes the JAX modules
declare: he-normal conv kernels, BatchNorm scale/bias and running
statistics away from their init values (so a swapped mapping shows), and
a random localizer head so that theta differs per image.

Tolerance: 1e-4 relative to the largest magnitude of the compared output.
Both sides run float32 convolutions whose sums are taken in another order
(XLA's CPU convolution against PyTorch's), and the differences grow with
depth through the residual stages; a layout or mapping error shows as an
O(1) relative difference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from loans_tpu import models as jmodels
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch import bridge, models
from loans_tpu_torch.ops.geometry import Size

RTOL = 1e-4


def random_variables(module, x, seed, head_std=1e-3, **kw):
    """Seeded numpy weights in the shapes of ``module.init``. The
    localizer head is random N(0, head_std); see ``fit_head``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x, **kw))
    rng = np.random.default_rng(seed)
    out = {}
    for col in ("params", "batch_stats"):
        leaves = {}
        for path, s in flatten_dict(shapes.get(col, {})).items():
            name = path[-1]
            if "param_predictor" in path:
                value = (
                    rng.normal(0.0, head_std, s.shape)
                    if name == "kernel"
                    else np.array([0.8, 0.0, 0.0, 0.0, 0.8, 0.0])
                )
            elif name == "kernel":
                value = rng.normal(0.0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape)
            elif name in ("scale", "var"):
                value = rng.uniform(0.5, 1.5, s.shape)
            else:  # bias, mean
                value = rng.normal(0.0, 0.1, s.shape)
            leaves[path] = value.astype(np.float32)
        if leaves:
            out[col] = unflatten_dict(leaves)
    return out


def fit_head(localizer, variables, x, seed, spread=0.15):
    """Set a JAX localizer's random head so that theta on ``x`` is the
    reference's initial [0.8, 0, 0, 0, 0.8, 0] plus per-image offsets of
    about ``spread``: random backbones give pooled features of large and
    shared magnitude, which a plain random head turns into crops far
    outside the image."""
    _, state = localizer.apply(variables, x, train=False, mutable=["vbp_anchor"])
    feats = np.asarray(state["vbp_anchor"]["anchor"][0]).mean(axis=(1, 2))
    mu, sd = feats.mean(0), feats.std(0).mean() + 1e-6
    rng = np.random.default_rng(seed)
    kernel = rng.normal(0.0, spread / (np.sqrt(feats.shape[1]) * sd), (feats.shape[1], 6))
    bias = np.array([0.8, 0.0, 0.0, 0.0, 0.8, 0.0]) - mu @ kernel
    head = variables["params"]["param_predictor"]
    head["kernel"], head["bias"] = kernel.astype(np.float32), bias.astype(np.float32)
    return variables


def assert_close_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max abs err {err} > {rtol} * {scale}"


def images(seed, n, size):
    return np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)


# -- bridge ---------------------------------------------------------------


def _assessor_pair(ch=8, size=16):
    x = jnp.zeros((1, size, size, 3))
    variables = random_variables(jmodels.ResnetAssessor(ch=ch), x, seed=0)
    return variables["params"], models.ResnetAssessor(ch=ch, in_size=Size(size, size))


def test_bridge_maps_every_leaf():
    """Each flax leaf lands on its key in PyTorch layout, and a strict
    ``load_state_dict`` accepts the result."""
    params, model = _assessor_pair()
    state = bridge.assessor_state_dict(model, params)
    model.load_state_dict(state)
    flat = bridge.flatten_variables(params)
    assert len(flat) == len(state)
    np.testing.assert_array_equal(
        state["DownResBlock1_0.Conv_2.weight"].numpy(),
        flat["DownResBlock1_0/Conv_2/kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(state["Dense_0.weight"].numpy(), flat["Dense_0/kernel"].T)


def test_bridge_accepts_flat_paths():
    params, model = _assessor_pair()
    nested = bridge.assessor_state_dict(model, params)
    flat = bridge.assessor_state_dict(model, bridge.flatten_variables(params))
    assert nested.keys() == flat.keys()
    for k in nested:
        torch.testing.assert_close(nested[k], flat[k], rtol=0, atol=0)


def test_bridge_raises_on_missing_key():
    params, model = _assessor_pair()
    flat = bridge.flatten_variables(params)
    del flat["DownResBlock3_1/Conv_0/kernel"]
    with pytest.raises(KeyError, match="DownResBlock3_1.Conv_0.weight"):
        bridge.assessor_state_dict(model, flat)


def test_bridge_raises_on_extra_key():
    params, model = _assessor_pair()
    flat = bridge.flatten_variables(params)
    flat["DownResBlock3_2/Conv_0/kernel"] = flat["DownResBlock3_1/Conv_0/kernel"]
    with pytest.raises(KeyError, match="extra"):
        bridge.assessor_state_dict(model, flat)


def test_bridge_raises_on_shape_mismatch():
    params, model = _assessor_pair()
    other = models.ResnetAssessor(ch=8, in_size=Size(24, 24))
    with pytest.raises(ValueError, match="Dense_0.weight"):
        bridge.assessor_state_dict(other, params)


def test_bridge_localizer_fills_batchnorm_counters():
    x = jnp.zeros((1, 32, 32, 3))
    jm = jmodels.Localizer(out_size=JSize(8, 8), n_layers=18, input_size=JSize(32, 32))
    v = random_variables(jm, x, seed=1, train=False)
    model = models.Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32))
    state = bridge.localizer_state_dict(model, v["params"], v["batch_stats"])
    model.load_state_dict(state)
    np.testing.assert_array_equal(
        model.feature_extractor.BatchNorm_0.running_var.numpy(),
        v["batch_stats"]["feature_extractor"]["BatchNorm_0"]["var"],
    )
    assert int(model.feature_extractor.BatchNorm_0.num_batches_tracked) == 0


# -- forward parity -------------------------------------------------------


@pytest.mark.parametrize("n_layers", [18, 50])
def test_resnet_features_match_jax(n_layers):
    x = images(2, 2, 64)
    jm = jmodels.ResNet(n_layers)
    v = random_variables(jm, jnp.asarray(x), seed=n_layers, train=False)
    want = jm.apply(v, jnp.asarray(x), train=False)
    model = models.ResNet(n_layers)
    model.load_state_dict(bridge.to_state_dict(model, v["params"], v["batch_stats"]))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_rel(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize(
    "input_size,grayscale",
    [(64, False), (320, True)],  # 320: res6 and res7 are built and run
)
def test_localizer_matches_jax(input_size, grayscale):
    x = images(3, 3, 64)
    kw = dict(n_layers=18, transform_rois_to_grayscale=grayscale)
    jm = jmodels.Localizer(out_size=JSize(16, 16), input_size=JSize(input_size, input_size), **kw)
    v = fit_head(jm, random_variables(jm, jnp.asarray(x), seed=4, train=False), x, seed=4)
    want_rois, want_theta = jm.apply(v, jnp.asarray(x), train=False)
    model = models.Localizer(out_size=Size(16, 16), input_size=Size(input_size, input_size), **kw)
    assert hasattr(model, "res7") == (input_size > 300)
    model.load_state_dict(bridge.localizer_state_dict(model, v["params"], v["batch_stats"]))
    with torch.inference_mode():
        rois, theta = model.eval()(torch.from_numpy(x))
    assert rois.shape == (3, 16, 16, 1 if grayscale else 3)
    assert float(np.ptp(np.asarray(want_theta)[:, 0, 0])) > 0.05  # theta varies per image
    assert_close_rel(theta.numpy(), want_theta)
    # A theta error d moves every sample by d * (64 - 1) / 2 px, and the
    # uniform-noise images change by up to 1 per px: theta agrees to about
    # 5e-6, so the crops agree to about 2e-4.
    np.testing.assert_allclose(rois.numpy(), np.asarray(want_rois), atol=5e-4)


@pytest.mark.parametrize("ch", [8, 128])
def test_assessor_matches_jax(ch):
    crops = images(5, 3, 75)
    jm = jmodels.ResnetAssessor(ch=ch)
    v = random_variables(jm, jnp.asarray(crops), seed=ch)
    want = jm.apply(v, jnp.asarray(crops))
    model = models.ResnetAssessor(ch=ch, in_size=Size(75, 75))
    assert model.fan_in == 18 * 18 * ch
    model.load_state_dict(bridge.assessor_state_dict(model, v["params"]))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(crops))
    assert got.dtype == torch.float32 and got.shape == (3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
