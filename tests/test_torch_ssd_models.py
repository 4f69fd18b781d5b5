"""The port's SSD300 and SSD512 (``loans_tpu_torch/models/ssd.py``) against
the JAX package's (``loans_tpu/models/ssd.py``) on the same weights,
carried across by ``bridge.ssd_state_dict``, on the CPU at full width.

* float32 forward at batch 1: both multibox outputs within 1e-5 of their
  largest magnitude (measured 3.4e-6 on SSD300 and SSD512: float32
  convolutions of depth up to 4608 summed in another order). Anchor order
  is part of it: a head reshaped in NCHW order would score every anchor
  against another anchor's box;
* bfloat16 forward: within twice JAX's own bf16 error against its float32
  forward, as ``test_torch_supervised.py`` holds the localizer, and no
  closer to the port's float32 forward than a quarter of it (the port
  really rounds); every convolution computes in bfloat16 while L2Norm and
  the outputs stay float32;
* the bridge is strict: a missing leaf, an extra leaf or a shape mismatch
  raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables  # noqa: E402

from loans_tpu.models import ssd as jssd
from loans_tpu_torch import bridge
from loans_tpu_torch.models import SSD300, SSD512, resnet, ssd

PORT = {"SSD300": SSD300, "SSD512": SSD512}
SIZE = {"SSD300": 300, "SSD512": 512}
FWD_TOL = 1e-5


def ssd_variables(name: str, seed: int, conf_scale: float = 1.0, loc_scale: float = 1.0) -> dict:
    """Seeded numpy weights in the JAX SSD's shapes (``random_variables``),
    L2Norm's scale at its initial 20, and the multibox head's loc and conf
    kernels scaled by ``loc_scale`` and ``conf_scale`` (the raw forward's
    outputs are in the thousands; a scaled head gives scores between 0
    and 1)."""
    s = SIZE[name]
    variables = random_variables(getattr(jssd, name)(), jnp.zeros((1, s, s, 3)), seed, train=False)
    params = variables["params"]
    params["VGG16Extractor_0"]["L2Norm_0"]["scale"] = np.full((512,), 20.0, np.float32)
    for key, conv in params["Multibox_0"].items():
        scale = conf_scale if int(key.split("_")[1]) % 2 else loc_scale
        conv["kernel"] = (conv["kernel"] * scale).astype(np.float32)
    return variables


def port_ssd(name: str, variables: dict, dtype=torch.float32) -> torch.nn.Module:
    model = PORT[name](dtype=dtype)
    model.load_state_dict(bridge.ssd_state_dict(model, variables["params"]))
    return model.eval()


def jax_forward(name: str, variables: dict, x: np.ndarray, dtype=jnp.float32):
    model = getattr(jssd, name)(dtype=dtype)
    loc, conf = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    return np.asarray(loc), np.asarray(conf)


@pytest.mark.parametrize("name", ["SSD300", "SSD512"])
def test_forward_matches_jax(name):
    variables = ssd_variables(name, seed=0)
    s = SIZE[name]
    x = np.random.default_rng(1).uniform(size=(1, s, s, 3)).astype(np.float32)
    want = jax_forward(name, variables, x)
    with torch.no_grad():
        got = port_ssd(name, variables)(torch.from_numpy(x))
    k = {"SSD300": 8732, "SSD512": 24564}[name]
    for g, w, width in zip(got, want, (4, 2)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape == (1, k, width)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= FWD_TOL * scale, (err, scale)


def test_bf16_forward_within_jax_bf16_error():
    name = "SSD300"
    variables = ssd_variables(name, seed=2)
    x = np.random.default_rng(3).uniform(size=(1, 300, 300, 3)).astype(np.float32)
    j_bf16 = jax_forward(name, variables, x, jnp.bfloat16)
    j_f32 = jax_forward(name, variables, x)
    model = port_ssd(name, variables, torch.bfloat16)
    seen = {"conv": set(), "l2norm": set()}
    for m in model.modules():
        if isinstance(m, resnet.Conv2d):
            m.register_forward_hook(lambda mod, i, out: seen["conv"].add(out.dtype))
        elif isinstance(m, ssd.L2Norm):
            m.register_forward_hook(lambda mod, i, out: seen["l2norm"].add(out.dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        port_f32 = port_ssd(name, variables)(torch.from_numpy(x))
    assert seen == {"conv": {torch.bfloat16}, "l2norm": {torch.float32}}
    for g, jb, jf, pf in zip(got, j_bf16, j_f32, port_f32):
        assert g.dtype == torch.float32
        bf16_error = float(np.abs(jb - jf).max())  # JAX's own bf16 rounding
        assert 1e-3 * np.abs(jf).max() < bf16_error < 0.1 * np.abs(jf).max()
        assert float(np.abs(g.numpy() - jb).max()) <= 2 * bf16_error
        assert float((g - pf).abs().max()) > bf16_error / 4


def test_bridge_is_strict():
    variables = ssd_variables("SSD300", seed=4)
    model = SSD300()
    params = variables["params"]
    with pytest.raises(KeyError, match="missing.*ExtraLayers_0.Conv_8"):  # SSD512 has a conv12
        bridge.ssd_state_dict(SSD512(), params)
    scale = params["VGG16Extractor_0"]["L2Norm_0"].pop("scale")
    with pytest.raises(KeyError, match="L2Norm_0.weight"):
        bridge.ssd_state_dict(model, params)
    params["VGG16Extractor_0"]["L2Norm_0"]["scale"] = scale[:256]
    with pytest.raises(ValueError, match="L2Norm_0.weight"):
        bridge.ssd_state_dict(model, params)
    params["VGG16Extractor_0"]["L2Norm_0"]["scale"] = scale
    params["Multibox_0"]["Conv_12"] = dict(params["Multibox_0"]["Conv_0"])
    with pytest.raises(KeyError, match="extra"):
        bridge.ssd_state_dict(model, params)
