"""VisualBackprop of the PyTorch port against the JAX package's.

The JAX models ``sow`` the channel mean of each main-branch conv/pool
input and the anchor; ``flatten_vbp`` orders them. The port records the
same tensors in call order when ``forward`` is given a list. With one set
of numpy-seeded weights carried across by the bridge:

* the static ladders (``resnet_vbp_ladder``, ``localizer_vbp_ladder``)
  equal the JAX package's tuples for every depth and for inputs that add
  ``res6`` (> 224) and ``res7`` (> 300);
* the recorded inputs equal ``flatten_vbp``'s in count, order and shape,
  and in value within 1e-5 of each map's largest magnitude (the float32
  networks differ only in summation order: measured under 1e-6), as does
  the anchor;
* each step of both ladders (the transposed ones-kernel convolution and the
  crop to the next input) equals JAX's on the same relevance map to 1e-6:
  ``lax.conv_transpose`` pads the dilated input, ``F.conv_transpose2d``
  crops its output, so the port maps one padding onto the other;
* the heat map agrees within 1e-5 absolute (it lies in [0, 1]; measured
  under 1e-6, and each side's float32 heat map lies about as far from a
  float64 one);
* in bfloat16 (R-18), the recorded inputs, anchor and heat map agree with
  JAX's bf16 run within twice JAX's own bf16 error, measured against its
  float32 run on the same weights.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loans_tpu import models as jmodels
from loans_tpu.models.localizer import localizer_vbp_ladder as jax_localizer_ladder
from loans_tpu.models.resnet import BLOCK_CONFIGS
from loans_tpu.models.resnet import resnet_vbp_ladder as jax_resnet_ladder
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch import bridge, models
from loans_tpu_torch.models.localizer import localizer_vbp_ladder
from loans_tpu_torch.models.resnet import resnet_vbp_ladder
from loans_tpu_torch.ops.geometry import Size
from test_torch_models import random_variables

jvbp = importlib.import_module("loans_tpu.insights.visual_backprop")
vbp = importlib.import_module("loans_tpu_torch.insights.visual_backprop")
REL_TOL = 1e-5
HEAT_TOL = 1e-5
STEP_TOL = 1e-6


@pytest.mark.parametrize("n_layers", sorted(BLOCK_CONFIGS))
def test_resnet_ladder_matches_jax(n_layers):
    assert resnet_vbp_ladder(n_layers) == tuple(jax_resnet_ladder(n_layers))


@pytest.mark.parametrize("n_layers", [18, 34, 50, 101])
@pytest.mark.parametrize("size", [64, 224, 232, 300, 304])
def test_localizer_ladder_matches_jax(n_layers, size):
    want = tuple(jax_localizer_ladder(n_layers, JSize(size, size)))
    assert localizer_vbp_ladder(n_layers, Size(size, size)) == want
    loc = models.Localizer(out_size=Size(8, 8), n_layers=n_layers, input_size=Size(size, size))
    assert loc.vbp_ladder() == want


def _run_both(n_layers, size, dtype=jnp.float32, tdtype=torch.float32, seed=5):
    """JAX's and the port's recorded inputs (NHWC numpy, float32), anchor
    and heat map, from one seeded set of weights."""
    jl = jmodels.Localizer(out_size=JSize(8, 8), n_layers=n_layers, input_size=JSize(size, size),
                           dtype=dtype, norm_dtype=dtype)
    x = np.random.default_rng(seed + 1).uniform(size=(2, size, size, 3)).astype(np.float32)
    v = random_variables(jl, jnp.asarray(x), seed=seed, train=False)
    _, state = jl.apply(v, jnp.asarray(x), train=False, mutable=["vbp", "vbp_anchor"])
    j_inputs = jvbp.flatten_vbp(state["vbp"])
    j_anchor = state["vbp_anchor"]["anchor"][0]
    jax_out = {
        "inputs": [np.asarray(a, np.float32) for a in j_inputs],
        "anchor": np.asarray(j_anchor, np.float32),
        "heat": np.asarray(jvbp.visual_backprop(j_anchor, j_inputs, jl.vbp_ladder())),
    }
    loc = models.Localizer(out_size=Size(8, 8), n_layers=n_layers, input_size=Size(size, size),
                           dtype=tdtype, norm_dtype=tdtype)
    loc.load_state_dict(bridge.localizer_state_dict(loc, v["params"], v["batch_stats"]))
    recorded = []
    with torch.no_grad():
        loc.eval()(torch.from_numpy(x), vbp=recorded)
    *inputs, anchor = recorded
    port_out = {
        "inputs": [t.float().permute(0, 2, 3, 1).numpy() for t in inputs],
        "anchor": anchor.float().permute(0, 2, 3, 1).numpy(),
        "heat": vbp.visual_backprop(anchor, inputs, loc.vbp_ladder()).numpy(),
        "torch_inputs": inputs,
        "torch_anchor": anchor,
        "ladder": loc.vbp_ladder(),
    }
    assert np.array_equal(vbp.localizer_visual_backprop(loc, torch.from_numpy(x)), port_out["heat"])
    return jax_out, port_out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("n_layers,size", [(18, 64), (50, 96), (18, 304), (50, 232)])
def test_recorded_inputs_and_heat_match_jax(n_layers, size):
    want, got = _run_both(n_layers, size)
    ladder = got["ladder"]
    assert len(got["inputs"]) == len(want["inputs"]) == len(ladder)
    assert [a.shape for a in got["inputs"]] == [a.shape for a in want["inputs"]]
    for i, (g, w) in enumerate(zip(got["inputs"], want["inputs"])):
        assert _rel(g, w) <= REL_TOL, (i, ladder[i])
    assert got["anchor"].shape == want["anchor"].shape
    assert _rel(got["anchor"], want["anchor"]) <= REL_TOL
    assert got["heat"].shape == want["heat"].shape == (2, size, size, 1)
    assert got["heat"].min() >= 0.0 and got["heat"].max() <= 1.0
    assert float(np.ptp(want["heat"])) > 0.5  # a heat map, not a constant
    assert float(np.abs(got["heat"] - want["heat"]).max()) <= HEAT_TOL

    # every step of the ladder on its real shapes, from one relevance map
    rng = np.random.default_rng(7)
    shapes = [t.shape for t in got["torch_inputs"]] + [got["torch_anchor"].shape]
    for i, (_, kernel, stride, pad) in enumerate(ladder):
        n, _, h, w = shapes[i + 1]
        rel = rng.uniform(size=(n, h, w, 1)).astype(np.float32)
        j = jvbp._fit_to(jvbp._ones_deconv(jnp.asarray(rel), kernel, stride, pad), *shapes[i][2:])
        p = vbp._fit_to(vbp._ones_deconv(torch.from_numpy(rel).permute(0, 3, 1, 2), kernel, stride, pad),
                        *shapes[i][2:])
        p = p.permute(0, 2, 3, 1).numpy()
        assert p.shape == np.asarray(j).shape == (n, *shapes[i][2:], 1), (i, ladder[i])
        assert float(np.abs(p - np.asarray(j)).max()) <= STEP_TOL * float(np.abs(np.asarray(j)).max())


@pytest.mark.parametrize("kernel,stride,pad", [(7, 2, 3), (3, 2, 0), (3, 2, 1), (1, 2, 0), (1, 2, 2), (3, 1, 3)])
def test_ones_deconv_padding_matches_jax(kernel, stride, pad):
    """``lax.conv_transpose``'s padding on the port's side, where it equals
    ``(kernel - 1) / 2`` and where it does not, more than ``kernel - 1``
    included."""
    rel = np.random.default_rng(kernel * 10 + pad).uniform(size=(2, 5, 6, 1)).astype(np.float32)
    want = np.asarray(jvbp._ones_deconv(jnp.asarray(rel), kernel, stride, pad))
    got = vbp._ones_deconv(torch.from_numpy(rel).permute(0, 3, 1, 2), kernel, stride, pad)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_bf16_recorded_inputs_and_heat_match_jax():
    want, got = _run_both(18, 64, jnp.bfloat16, torch.bfloat16)
    want32, _ = _run_both(18, 64)
    assert [a.shape for a in got["inputs"]] == [a.shape for a in want["inputs"]]
    for key in ("inputs", "anchor"):
        pairs = zip(got[key], want[key], want32[key]) if key == "inputs" else [(got[key], want[key], want32[key])]
        for g, w, w32 in pairs:
            bf16_error = _rel(w, w32)  # JAX's own bf16 rounding
            assert _rel(g, w) <= max(2 * bf16_error, REL_TOL)
    heat_error = float(np.abs(want["heat"] - want32["heat"]).max())
    assert heat_error > 1e-4  # both really ran in bfloat16
    assert float(np.abs(got["heat"] - want["heat"]).max()) <= 2 * heat_error


def test_recording_changes_nothing_else():
    """Without a list nothing is recorded; with one, the outputs are the
    same bits."""
    torch.manual_seed(0)
    loc = models.Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32)).eval()
    x = torch.rand(2, 32, 32, 3)
    recorded = []
    with torch.no_grad():
        rois, theta = loc(x)
        rois_v, theta_v = loc(x, vbp=recorded)
    assert torch.equal(rois, rois_v) and torch.equal(theta, theta_v)
    assert len(recorded) == len(loc.vbp_ladder()) + 1
    with pytest.raises(ValueError, match="ladder steps"):
        vbp.visual_backprop(recorded[-1], recorded[:-2], loc.vbp_ladder())
