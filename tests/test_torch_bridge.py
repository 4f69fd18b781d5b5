"""The torch->flax direction of the weight bridge
(``loans_tpu_torch/bridge.py::from_state_dict``) and
``tools/import_torch_snapshot.py``, against the JAX package on the CPU:

* the round trip flax -> ``to_state_dict`` -> ``from_state_dict`` gives
  back every leaf of ``params`` and ``batch_stats`` bit for bit, in the
  trees of the JAX modules' ``init`` (``jax.eval_shape``; seeded values)
  for the R-18 and R-50 localizers, the assessor and SSD300;
  ``num_batches_tracked`` is dropped and an unknown key raises;
* a tiny log dir trained by the port's CLI on the CPU, imported into
  ``.msgpack`` snapshots, is served by JAX's ``LocalizerInference``: the
  imported leaves equal the port's ``state_dict`` bit for bit, and the
  boxes are within 1e-3 px, the rois 1e-4 and the scores 1e-5 of the
  port's own serving of the ``.pt`` snapshots (``test_torch_inference.py``'s
  tolerances: the float32 networks differ in summation order only).
"""

import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from test_torch_models import random_variables  # noqa: E402

from loans_tpu import models as jmodels
from loans_tpu.inference import LocalizerInference as JaxInference
from loans_tpu.models import ssd as jssd
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import train_localizer
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.models import SSD300, Localizer, ResnetAssessor
from loans_tpu_torch.ops import Size
from loans_tpu_torch.train import checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import import_torch_snapshot  # noqa: E402

MODELS = {
    "R-18 localizer": (lambda: jmodels.Localizer(out_size=JSize(8, 8), n_layers=18, input_size=JSize(32, 32)),
                       lambda: Localizer(out_size=Size(8, 8), n_layers=18, input_size=Size(32, 32)),
                       (1, 32, 32, 3), {"train": False}),
    "R-50 localizer": (lambda: jmodels.Localizer(out_size=JSize(8, 8), n_layers=50, input_size=JSize(32, 32)),
                       lambda: Localizer(out_size=Size(8, 8), n_layers=50, input_size=Size(32, 32)),
                       (1, 32, 32, 3), {"train": False}),
    "assessor": (jmodels.ResnetAssessor, lambda: ResnetAssessor(in_size=Size(16, 16)), (1, 16, 16, 3), {}),
    "SSD300": (jssd.SSD300, SSD300, (1, 300, 300, 3), {"train": False}),
}


def assert_trees_equal(got: dict, want: dict):
    got, want = flatten_dict(got), flatten_dict(want)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


@pytest.mark.parametrize("name", list(MODELS))
def test_round_trip_is_bit_for_bit(name):
    jax_module, port_module, shape, kw = MODELS[name]
    variables = random_variables(jax_module(), jnp.zeros(shape), seed=3, **kw)
    model = port_module()
    state = bridge.to_state_dict(model, variables["params"], variables.get("batch_stats"))
    params, batch_stats = bridge.from_state_dict(state)
    assert_trees_equal(params, variables["params"])
    assert_trees_equal(batch_stats, variables.get("batch_stats", {}))
    assert (len(flatten_dict(params)) + len(flatten_dict(batch_stats))
            == len([k for k in state if not k.endswith("num_batches_tracked")]))


def test_from_state_dict_refuses_unknown_keys():
    with pytest.raises(KeyError, match="no flax counterpart"):
        bridge.from_state_dict({"Conv_0.weight_v": torch.zeros(3)})
    with pytest.raises(KeyError, match="3-D weight"):
        bridge.from_state_dict({"Conv_0.weight": torch.zeros(3, 3, 3)})
    assert bridge.from_state_dict({"BatchNorm_0.num_batches_tracked": torch.tensor(4)}) == ({}, {})


ARGV = ["synthetic:16", "synthetic:16", "synthetic:8", "--batch-size", "8", "--n-layers", "18",
        "--target-size", "32", "32", "--crop-size", "8", "8", "--steps-per-call", "2", "--iterations", "4",
        "--log-interval", "2", "--snapshot-interval", "2", "--eval-batches", "1", "--device", "cpu"]


def test_imported_port_log_dir_serves_in_jax(tmp_path):
    log_dir = train_localizer.main(ARGV + ["--log-dir", str(tmp_path)])
    written = import_torch_snapshot.main([log_dir])
    assert sorted(os.path.basename(p) for p in written) == [
        "Localizer_2.msgpack", "Localizer_4.msgpack", "ResnetAssessor_2.msgpack", "ResnetAssessor_4.msgpack"]
    for name in ("Localizer", "ResnetAssessor"):
        with open(os.path.join(log_dir, f"{name}_4.msgpack"), "rb") as f:
            raw = serialization.msgpack_restore(f.read())
        state = checkpoint.load_params(os.path.join(log_dir, f"{name}_4.pt"))
        want = {k: v.numpy() for k, v in state.items() if not k.endswith("num_batches_tracked")}
        got = bridge.torch_leaves(raw["params"], raw["batch_stats"])
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want), name

    frames = np.random.default_rng(1).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    ref = JaxInference(log_dir, use_assessor=True, score_threshold=0.0)
    port = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    want_boxes, want_rois, want_scores = (np.asarray(a) for a in ref.localize_batch(frames)[:3])
    boxes, rois, scores, _ = port.localize_batch(frames)
    np.testing.assert_allclose(boxes, want_boxes, atol=1e-3)
    np.testing.assert_allclose(rois, want_rois, atol=1e-4)
    np.testing.assert_allclose(scores, want_scores, atol=1e-5)
    assert np.ptp(boxes[:, 0, 0]) > 0.1  # boxes differ per frame
    shutil.rmtree(log_dir)
