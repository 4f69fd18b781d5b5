"""Data-parallel backbone pretraining of the port
(``cli.pretrain_backbone`` under ``torchrun``) on the CPU over gloo.

* One classifier step on two worker processes
  (``tests/torch_parallel_worker.py``, case ``classifier``), each on its
  half of a global batch of 8 at R-18 64², with the flips drawn for the
  global batch, against the JAX tool's step (``tools/pretrain_backbone.py``'s
  body) jitted over a 2-device mesh of the conftest's CPU devices, the
  batch sharded on ``data`` and the state replicated, with the flip mask
  of one process's draw handed over. JAX runs it in float64 (under x64):
  in float32 its sharded gradients of the last stage lie further from its
  float64 ones than the tolerances below (flax's E[x²] - E[x]² over the
  sharded batch at res5, 2x2 an image), while its unsharded float32 step
  and the port stay within them. Tolerances of
  ``test_torch_pretrain.py``'s one step, with its reasons: the loss 1e-5
  relative, the accuracy equal, the BatchNorm statistics 1e-5 of a
  tensor's largest, the parameters within 2 lr + 1e-7 everywhere, 1e-6
  where JAX's Adam moment is at least a tenth of its tensor's largest and
  on 99% of the entries. Against one process of the port at the global
  batch (``test_torch_parallel.py``'s header): metrics 1e-6 relative, the
  BatchNorm statistics and Adam's moment 1e-4 of a tensor's largest (the
  same float32 operations with the batch's sums split in two), the
  parameters within 2 lr everywhere and 1e-6 where the moment is sure of
  its sign; the replicas equal bit for bit.
* The CLI as 2 processes under ``torchrun`` against 1 process of the same
  argv (R-50 64², 4 classes, global batch 8, two log entries of one step
  each, lr 1e-5, ``--device cpu``), through
  ``tests/torch_pretrain_runner.py``. The first entry is the step from the
  common start: its loss and accuracy 1e-4 relative (``hold_logs``;
  measured 3.7e-6). The second follows one update, and a fresh R-50 at
  batch 8 amplifies float32 rounding there: one process at 1 and at 4
  threads logs losses 4.3e-4 and 9.3e-4 apart (pools of 32 and 16 scenes;
  at lr 1e-3, 1.2e-2 apart), so its loss is held to 5e-3 relative and its
  accuracy to one image of the batch. At 32² res5 is 1x1 and the first
  step itself parts by 7e-5. The validation accuracy equal; one export,
  written by rank 0: its parameters by ``test_torch_parallel_cli.py``'s
  ``hold_snapshots`` rule (2 lr a step + 1e-6 everywhere, 1e-5 on 99% of
  the entries), its BatchNorm statistics, which lr does not scale and
  which the second step adds, 5e-3 of a tensor's largest as that step's
  loss. A global batch that the world size does
  not divide is refused.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from loans_tpu.models.resnet import ResNet as JaxResNet
from loans_tpu.parallel import replicate as jreplicate, shard_batch as jshard
from loans_tpu.train import state as jstate
from loans_tpu_torch import bridge
from loans_tpu_torch.cli import pretrain_backbone
from loans_tpu_torch.train import create_train_state
from test_torch_parallel import WORLD, collect, start_workers  # noqa: E402
from test_torch_parallel_cli import ENV, ROOT, finish, hold_logs  # noqa: E402
from test_torch_pretrain import CLASSES, IMG, JAX_MEAN, LR, assert_rel, jax_variables, port_model, scenes  # noqa: E402

GLOBAL_BATCH = 8
FLIP_SEED = 2  # a generator seed whose mask of 8 differs between the two halves
RUNNER = os.path.join(ROOT, "tests", "torch_pretrain_runner.py")
CLI_LR = 1e-5
CLI_ARGV = ["--classes", "4", "--pool", "32", "--val-pool", "16", "--iterations", "2", "--batch-size", "8",
            "--steps-per-call", "1", "--log-interval", "1", "--image-size", "64", "--lr", str(CLI_LR),
            "--device", "cpu"]
AFTER_UPDATE_RTOL = 5e-3


def jax_sharded_step(variables, images, labels, flip, dtype=jnp.float64):
    """The JAX tool's body with the flip mask given, jitted over a 2-device
    mesh: the batch sharded on ``data``, the state replicated; in
    ``dtype`` (float64 under x64 by default: see the module's docstring).
    Returns the state after the step (as numpy), the loss and the
    accuracy."""
    with jax.enable_x64(dtype == jnp.float64):
        jm = JaxResNet(18, class_labels=CLASSES, dtype=dtype, norm_dtype=dtype)
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
        tx = jstate.adam_amsgrad(LR)
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, dtype), variables[k]) for k in ("params", "batch_stats"))
        state = jreplicate(mesh, jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                                   opt_state=tx.init(params), tx=tx))
        batch = jshard(mesh, {"images": jnp.asarray(images), "labels": jnp.asarray(labels), "flip": jnp.asarray(flip)})

        def step(state, batch):
            x = batch["images"].astype(dtype) - jnp.asarray(JAX_MEAN, dtype)
            x = jnp.where(batch["flip"][:, None, None, None], x[:, :, ::-1, :], x)

            def loss_fn(params):
                logits, new = jm.apply({"params": params, "batch_stats": state.batch_stats}, x, train=True,
                                       mutable=["batch_stats"])
                loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch["labels"]).mean()
                return loss, (new["batch_stats"], jnp.mean(jnp.argmax(logits, -1) == batch["labels"]))

            (loss, (stats, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            return state.apply_gradients(grads, new_batch_stats=stats), loss, acc

        state, loss, acc = jax.jit(step)(state, batch)
        return jax.tree.map(np.asarray, state), float(loss), float(acc)


@pytest.fixture(scope="module")
def classifier_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("classifier")
    _, v = jax_variables(18, seed=11)
    model = port_model(18, v)
    images, labels = scenes(12, GLOBAL_BATCH)
    inputs = {"classifier": {"n_layers": 18, "classes": CLASSES, "lr": LR, "seed": FLIP_SEED,
                             "weights": {k: t.numpy() for k, t in model.state_dict().items()},
                             "batch": {"images": images, "labels": labels}}}
    procs = start_workers(inputs, tmp)  # the ranks run while JAX and one process of the port do
    flip = pretrain_backbone.draw_flips(torch.Generator().manual_seed(FLIP_SEED), GLOBAL_BATCH)
    want_state, want_loss, want_acc = jax_sharded_step(v, images, labels, flip.numpy())
    one = create_train_state(model, LR)
    one, one_metrics = pretrain_backbone.classifier_step(
        one, {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}, flip)
    outs = [o["classifier"] for o in collect(procs, tmp)]
    shutil.rmtree(tmp)  # the weights and states on disk, ~0.2 GB
    return {"outs": outs, "flip": flip.numpy(), "model": model, "jax": (want_state, want_loss, want_acc),
            "one": {"metrics": {k: float(x) for k, x in one_metrics.items()},
                    "params": {k: t.numpy() for k, t in model.state_dict().items()},
                    "mu": {n: one.optimizer.state[p]["mu"].numpy() for n, p in model.named_parameters()}}}


def test_classifier_step_on_two_ranks_is_jax_s_on_a_mesh(classifier_runs):
    outs, flip = classifier_runs["outs"], classifier_runs["flip"]
    # the ranks drew the global mask and kept their halves, which differ
    assert np.array_equal(np.concatenate([o["flips"] for o in outs]), flip)
    assert not np.array_equal(flip[:4], flip[4:])
    want_state, want_loss, want_acc = classifier_runs["jax"]
    model = classifier_runs["model"]
    want = bridge.to_state_dict(model, want_state.params, want_state.batch_stats)
    mu_jax = bridge.to_state_dict(model, want_state.opt_state.inner_state[0].mu, want_state.batch_stats)
    for out in outs:
        assert abs(out["metrics"]["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        assert out["metrics"]["acc"] == want_acc
        close = total = 0
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            got = out["params"][key]
            if "running" in key:
                assert_rel(got, w.numpy(), 1e-5, key)
                continue
            diff = np.abs(got - w.numpy())
            assert diff.max() <= 2 * LR + 1e-7, key
            m = np.abs(mu_jax[key].numpy())
            assert diff[m >= 0.1 * m.max()].max() <= 1e-6, key
            close, total = close + int((diff <= 1e-6).sum()), total + diff.size
        assert close >= 0.99 * total


def test_classifier_step_on_two_ranks_is_one_process_s(classifier_runs):
    a, b = classifier_runs["outs"]
    one = classifier_runs["one"]
    for k in one["metrics"]:
        np.testing.assert_allclose(a["metrics"][k], one["metrics"][k], rtol=1e-6, err_msg=k)
    for k in one["mu"]:
        assert_rel(a["mu"][k], one["mu"][k], 1e-4, k)
    for k, w in one["params"].items():
        assert np.array_equal(a["params"][k], b["params"][k]), k
        if "running" in k:
            assert_rel(a["params"][k], w, 1e-4, k)
        elif "num_batches" not in k:
            delta = np.abs(a["params"][k] - w)
            assert delta.max() <= 2 * LR, k
            mu = np.abs(one["mu"][k])
            assert delta[mu >= 0.1 * mu.max()].max(initial=0.0) <= 1e-6, k


def run_cli(out_dir, nproc: int = 0, argv=CLI_ARGV) -> subprocess.Popen:
    """The runner over ``argv`` with ``--out <out_dir>/backbone.pt``, under
    ``torchrun --standalone`` with ``nproc`` processes where ``nproc`` > 0."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, RUNNER, os.path.join(out_dir, "result")] + argv + [
        "--out", os.path.join(out_dir, "backbone.pt")]
    if nproc:
        cmd[1:1] = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=ENV, cwd=ROOT)


def test_pretrain_cli_on_two_processes_is_one_process_s(tmp_path):
    two, one = run_cli(tmp_path / "two", 2), run_cli(tmp_path / "one")
    out_two, _ = finish(two), finish(one)
    results = [json.load(open(tmp_path / "two" / f"result.{r}.json")) for r in range(2)]
    want = json.load(open(tmp_path / "one" / "result.0.json"))
    assert [e["iteration"] for e in want["log"]] == [1, 2]
    for got in results:  # every rank returns the global metrics
        hold_logs(got["log"][:1], want["log"][:1])
        after, want_after = got["log"][1], want["log"][1]
        assert after["iteration"] == want_after["iteration"]
        np.testing.assert_allclose(after["loss"], want_after["loss"], rtol=AFTER_UPDATE_RTOL)
        assert abs(after["acc"] - want_after["acc"]) <= 1 / 8
        assert got["val_acc"] == want["val_acc"] and got["acc"] == after["acc"]
    # rank 0 alone prints and writes the export
    assert out_two.count("iter=") == 2 and out_two.count("wrote ") == 1
    assert sorted(os.listdir(tmp_path / "two")) == ["backbone.pt", "result.0.json", "result.1.json"]
    got, want = (torch.load(tmp_path / d / "backbone.pt", weights_only=True) for d in ("two", "one"))
    assert list(got) == list(want)
    close = total = 0
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
        elif "running" in k:
            assert_rel(got[k].numpy(), w.numpy(), AFTER_UPDATE_RTOL, k)
        else:
            diff = (got[k] - w).abs()
            assert float(diff.max()) <= 2 * 2 * CLI_LR + 1e-6, k
            close, total = close + int((diff <= 1e-5).sum()), total + diff.numel()
    assert close >= 0.99 * total
    shutil.rmtree(tmp_path)  # two R-50 exports


def test_pretrain_batch_not_divisible_by_the_world_is_refused(tmp_path):
    proc = run_cli(tmp_path, 2, CLI_ARGV + ["--batch-size", "5"])
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode != 0
    assert "--batch-size 5 not divisible by 2 devices" in out
    assert not os.listdir(tmp_path)
