"""The port's pretrained-weight converters against the JAX package's tools
(``tools/pretrain_backbone.py::export_torchvision_resnet50``,
``tools/import_resnet50.py``, ``tools/import_vgg16.py``), composed with
``loans_tpu_torch.bridge``: all equal bit for bit (both only move and
reverse float32 arrays). Checkpoints are drawn with numpy from a seed in
the published layouts at full shapes (``tests/test_import_resnet50.py``,
``tests/test_import_vgg16.py``); the restores count the keys
``train.checkpoint.restore_params`` returns, since it skips a key whose
name or shape does not match.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loans_tpu.models.resnet import ResNet as JaxResNet
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import import_resnet50, import_vgg16, pretrain_backbone
from loans_tpu_torch.models import SSD300, Localizer
from loans_tpu_torch.models.resnet import ResNet
from loans_tpu_torch.train import checkpoint

sys.path.insert(0, "tools")
sys.path.insert(0, "tests")

import import_resnet50 as jax_import_resnet50  # noqa: E402
import import_vgg16 as jax_import_vgg16  # noqa: E402
import pretrain_backbone as jax_pretrain  # noqa: E402
from test_import_resnet50 import fake_chainer_npz, fake_torch_state  # noqa: E402
from test_import_vgg16 import fake_vgg16_state  # noqa: E402
from test_torch_models import random_variables  # noqa: E402

BACKBONE_KEYS = 265  # R-50: 53 convolutions, 53 BatchNorms of 4 tensors (no counters)


def assert_same(got: dict, want: dict):
    """Equal keys, float32 CPU tensors, values bit for bit."""
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def backbone_keys(model: torch.nn.Module, prefix: str) -> list[str]:
    return [k for k in model.state_dict() if k.startswith(prefix) and not k.endswith("num_batches_tracked")]


@pytest.fixture(scope="module")
def jax_r50():
    """A JAX ``ResNet(50, class_labels=16)``'s seeded variables and the
    port's model carrying them."""
    jm = JaxResNet(50, class_labels=16)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=4, train=False)
    model = ResNet(50, class_labels=16)
    model.load_state_dict(bridge.to_state_dict(model, v["params"], v["batch_stats"]))
    return jax.tree.map(np.asarray, v), model


def test_bridge_carries_the_classifier_head(jax_r50):
    """``Dense_0``'s kernel (transposed) and bias, flax -> port -> flax."""
    v, model = jax_r50
    head = v["params"]["Dense_0"]
    np.testing.assert_array_equal(model.Dense_0.weight.detach().numpy(), head["kernel"].T)
    params, stats = bridge.from_state_dict(model.state_dict())
    for name in ("kernel", "bias"):
        np.testing.assert_array_equal(params["Dense_0"][name], head[name])
    assert "Dense_0" not in stats


# -- the converters against the JAX tools -----------------------------------------
def test_export_matches_jax_tool(jax_r50):
    v, model = jax_r50
    got = pretrain_backbone.export_torchvision_resnet50(model.state_dict())
    want = jax_pretrain.export_torchvision_resnet50(v["params"], v["batch_stats"])
    assert list(got) == list(want) and len(got) == 318
    for k, w in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(w)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert not any(k.startswith("fc") or "Dense" in k for k in got)


@pytest.mark.parametrize("source", ["torch", "chainer"])
def test_convert_matches_jax_tool(source):
    """``convert_torch`` / ``convert_chainer`` equal the JAX tool's, carried
    to the Localizer's keys by ``bridge.torch_leaves``."""
    if source == "torch":
        ckpt = fake_torch_state(np.random.default_rng(0))
        got, (params, stats) = import_resnet50.convert_torch(ckpt), jax_import_resnet50.convert_torch(ckpt)
    else:
        ckpt = fake_chainer_npz(np.random.default_rng(1))
        got, (params, stats) = import_resnet50.convert_chainer(ckpt), jax_import_resnet50.convert_chainer(ckpt)
    want = bridge.torch_leaves({"feature_extractor": params}, {"feature_extractor": stats})
    assert len(got) == BACKBONE_KEYS
    assert_same(got, want)


def test_chainer_conv1_is_reversed_to_rgb():
    npz = fake_chainer_npz(np.random.default_rng(2))
    got = import_resnet50.convert_chainer(npz)["feature_extractor.Conv_0.weight"]
    np.testing.assert_array_equal(got.numpy(), npz["conv1/W"][:, ::-1])
    np.testing.assert_array_equal(import_resnet50.convert_chainer(npz)["feature_extractor.BatchNorm_0.running_var"],
                                  npz["bn1/avg_var"])


def test_convert_vgg16_matches_jax_tool():
    """At full shapes: fc6 subsampled to (1024, 512, 3, 3), fc7 to (1024,
    1024, 1, 1), as JAX's kernels transposed to OIHW."""
    state = fake_vgg16_state(np.random.default_rng(0))
    got = import_vgg16.convert_vgg16(state)
    want = bridge.torch_leaves({"VGG16Extractor_0": jax_import_vgg16.convert_vgg16(state)})
    del state
    assert len(got) == 30
    assert got["VGG16Extractor_0.Conv_13.weight"].shape == (1024, 512, 3, 3)
    assert got["VGG16Extractor_0.Conv_14.weight"].shape == (1024, 1024, 1, 1)
    assert_same(got, want)


# -- into the models -----------------------------------------------------------------
@pytest.mark.parametrize("source", ["torch", "chainer"])
def test_imported_r50_fills_the_localizer(source, tmp_path):
    """The CLI's file restored into ``Localizer(n_layers=50)`` (head
    skipped) loads every backbone tensor; ``--verify`` says so."""
    rng = np.random.default_rng(5)
    if source == "torch":
        ckpt = str(tmp_path / "r50.pth")
        torch.save({k: torch.from_numpy(v) for k, v in fake_torch_state(rng).items()}, ckpt)
    else:
        ckpt = str(tmp_path / "r50.npz")
        np.savez(ckpt, **fake_chainer_npz(rng))
    out = import_resnet50.main([ckpt, str(tmp_path / "out.pt"), "--verify", "--device", "cpu"])
    torch.manual_seed(0)
    localizer = Localizer(n_layers=50)
    head = localizer.param_predictor.bias.detach().clone()
    loaded = checkpoint.restore_params(out, localizer, skip_prefixes=("param_predictor",))
    assert sorted(loaded) == sorted(backbone_keys(localizer, "feature_extractor."))
    assert len(loaded) == BACKBONE_KEYS
    file = checkpoint.load_params(out)
    for k in loaded:
        assert torch.equal(localizer.state_dict()[k], file[k]), k
    assert torch.equal(localizer.param_predictor.bias, head)


def test_verify_fails_on_a_misnamed_checkpoint(tmp_path):
    """A file whose keys miss the Localizer's loads nothing: ``--verify``
    exits with an error (the JAX tool's exit 1)."""
    state = fake_torch_state(np.random.default_rng(6))
    state["layer4.2.bn3.running_var"] = np.ones(7, np.float32)  # a shape the model does not have
    ckpt = str(tmp_path / "r50.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, ckpt)
    with pytest.raises(SystemExit, match="1 backbone tensors kept their fresh init"):
        import_resnet50.main([ckpt, str(tmp_path / "out.pt"), "--verify", "--device", "cpu"])


def test_pretrain_export_import_round_trip(tmp_path):
    """The port's R-50 classifier -> torchvision file -> ``convert_torch``:
    every backbone tensor back bit for bit, under the Localizer's keys."""
    torch.manual_seed(1)
    model = ResNet(50, class_labels=8)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if "running" in k:
                v.uniform_(0.5, 1.5)
    path = str(tmp_path / "backbone.pth")
    torch.save(pretrain_backbone.export_torchvision_resnet50(model.state_dict()), path)
    back = import_resnet50.convert_torch(torch.load(path, weights_only=True))
    want = {f"feature_extractor.{k}": v for k, v in model.state_dict().items()
            if not k.startswith("Dense_0") and not k.endswith("num_batches_tracked")}
    assert list(back) != [] and set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def test_imported_vgg16_fills_ssd300(tmp_path):
    """Every ``VGG16Extractor_0`` convolution of SSD300 loads from the CLI's
    file; ``L2Norm_0`` and the other layers keep their init."""
    ckpt = str(tmp_path / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in fake_vgg16_state(np.random.default_rng(1)).items()}, ckpt)
    out = import_vgg16.main([ckpt, str(tmp_path / "vgg16.pt")])
    (tmp_path / "vgg16.pth").unlink()
    torch.manual_seed(0)
    model = SSD300()
    l2 = model.VGG16Extractor_0.L2Norm_0.weight.detach().clone()
    loaded = checkpoint.restore_params(out, model)
    convs = [k for k in model.state_dict() if k.startswith("VGG16Extractor_0.Conv_")]
    assert sorted(loaded) == sorted(convs) and len(convs) == 30
    file = checkpoint.load_params(out)
    for k in loaded:
        assert torch.equal(model.state_dict()[k], file[k]), k
    assert torch.equal(model.VGG16Extractor_0.L2Norm_0.weight, l2)
