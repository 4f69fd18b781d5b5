"""Data-parallel training of the port (``loans_tpu_torch.parallel``) on
two gloo processes on the CPU against the JAX package's sharded step on a
2-device mesh of the conftest's virtual CPU devices.

Two worker processes (``tests/torch_parallel_worker.py``, the port only)
join a gloo group through an explicit ``init_method``, rank and world
size, and each runs every case on its half of the global batch; the test
process runs JAX on the whole batch, sharded on the mesh's ``data`` axis
with the states replicated (``loans_tpu.parallel``), as
``__graft_entry__.py::dryrun_multichip`` does. Weights go through
``bridge.py``; JAX's random draws are handed to the port (seeds are never
compared across frameworks).

Tolerances, with their reasons:

* BatchNorm (an NHWC (8, 8, 16, 16) batch, 4 images a rank) against
  flax's ``BatchNorm`` on all 8: outputs and d input 1e-5 of their
  largest entry, d scale and d bias (sums of 1024 products a channel)
  1e-6 of their largest entry, running mean and variance 1e-6 relative.
  Both take E[x²] - E[x]² in float32, summed in another order.
* The alternating step (R-18 64²→16², assessor ch 8, global batch 8, the
  reference's zero head) for 2 steps, at ratio 0 on the separable crop and
  at ratio 0.5 on K2's plain version (JAX: the dense rotated crop, the same
  function and VJP): the tolerances of ``tests/test_torch_train.py``, with
  their reasons there: metrics 1e-5 relative, assessor parameters 1e-6,
  BatchNorm statistics 1e-5 of a tensor's largest, the localizer after
  step 1 1e-6; after step 2 its Adam first moment to 3e-2 (5e-2 rotated,
  ``tests/test_torch_train_rotated.py``) and its parameters to 1e-6 where
  JAX's moment is sure of its sign, 2·lr everywhere.
* ``multibox_loss`` on one image a rank (7 and 2 positives) against JAX on
  both: losses 1e-6 relative, gradients 1e-6 of their largest entry, as
  ``tests/test_torch_multibox.py`` holds one process.
* One SSD300 step with the augmentation (JAX's draws) at global batch 2:
  losses 1e-5 relative and the parameters as
  ``tests/test_torch_ssd_device.py`` holds one process after one step
  (2·lr everywhere, 1e-6 on 99% and where JAX's moment is sure).
* The two ranks against one process of the port at the global batch (run
  in the test process): metrics 1e-6 relative; BatchNorm statistics and
  the localizer's Adam moment 1e-4 of each tensor's largest (the same
  float32 operations, with the batch's sums split in two; measured 1.7e-5
  for the moment after step 2); parameters by the rule above against
  JAX: within 2·lr a step everywhere, 1e-6 where the moment is sure of
  its sign (measured 4.4e-5 apart where it is not). The replicas equal
  each other exactly.
* The draws, the index columns and the refresh swap: exactly equal.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_ssd_device import LR as SSD_LR, _boxes, _hold_params, _jax_state as ssd_jax_state, jax_draws  # noqa: E402,E501
from test_torch_ssd_models import ssd_variables  # noqa: E402
from test_torch_multibox import _loss_inputs  # noqa: E402
from test_torch_train import (  # noqa: E402
    CH,
    CROP,
    IMG,
    LR,
    assert_rel,
    jax_mu,
    jax_state,
    make_batch,
    port_models,
    weights,  # noqa: F401  (the module's fixture)
)

from loans_tpu import models as jmodels
from loans_tpu.data import ssd_device as jsd
from loans_tpu.models import ssd as jssd
from loans_tpu.ops import multibox as jmb
from loans_tpu.ops.geometry import Size as JSize
from loans_tpu.parallel import replicate as jreplicate, shard_batch as jshard
from loans_tpu.train import steps as jsteps
from loans_tpu_torch import bridge
from loans_tpu_torch.bridge import _torch_leaf
from loans_tpu_torch.data import device_data
from loans_tpu_torch.data import ssd_device as sd
from loans_tpu_torch.data.device_augment import draw_flips, draw_jitter
from loans_tpu_torch.models import SSD300
from torch_parallel_worker import alternating_records  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
WORLD = 2
GLOBAL_BATCH = 8
RATIO = 0.5
# JAX's rotation-dropout draws for these step keys: keep the off-diagonals
# at step 1 (so that the rotated crop moves them), drop them at step 2
# (test_rotated_run_kept_then_dropped_the_off_diagonals reads both from
# JAX's Adam moments)
ROTATED_KEYS = (8, 9)
ROTATED_FLAGS = [True, False]
ONE_PROCESS_RTOL = 1e-4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(inputs: dict, tmp, world: int = WORLD) -> list[subprocess.Popen]:
    """Every case of ``inputs`` on ``world`` gloo processes, started."""
    torch.save(inputs, tmp / "in.pt")
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world), init, str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
            for r in range(world)]


def collect(procs: list[subprocess.Popen], tmp, timeout: float = 600) -> list[dict]:
    """The workers' outputs by rank; a failing rank fails the test with its
    output."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(len(procs))]


def mesh2():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


# -- inputs and JAX's side ----------------------------------------------------------
def bn_inputs():
    rng = np.random.default_rng(0)
    c = 16
    return {
        "x": rng.normal(1.5, 2.0, (8, 8, 16, c)).astype(np.float32),
        "g": rng.normal(size=(8, 8, 16, c)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(size=c).astype(np.float32),
        "running_mean": rng.normal(size=c).astype(np.float32),
        "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32),
    }


def bn_jax(inp):
    import flax.linen as fnn

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=2e-5)
    stats = {"mean": jnp.asarray(inp["running_mean"]), "var": jnp.asarray(inp["running_var"])}
    mesh = mesh2()
    x = jshard(mesh, jnp.asarray(inp["x"]))

    def f(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return y, upd["batch_stats"]

    (y, new), vjp = jax.vjp(jax.jit(f), x, jnp.asarray(inp["weight"]), jnp.asarray(inp["bias"]))
    dx, dscale, dbias = vjp((jnp.asarray(inp["g"]), jax.tree.map(jnp.zeros_like, new)))
    return {"y": y, "dx": dx, "dweight": dscale, "dbias": dbias,
            "running_mean": new["mean"], "running_var": new["var"]}


def jax_alternating(jl, ja, weights, batches, keys):  # noqa: F811
    """JAX's step body jitted over the 2-device mesh, the batch sharded on
    ``data`` and both states replicated; a record after each step."""
    mesh = mesh2()
    body = jax.jit(jsteps.alternating_step_body(jl, ja, jsteps.AlternatingConfig(image_size=JSize(IMG, IMG))))
    j_loc = jreplicate(mesh, jax_state(weights[0]["params"], weights[0]["batch_stats"]))
    j_ass = jreplicate(mesh, jax_state(weights[1]["params"]))
    records = []
    for batch, key in zip(batches, keys):
        j_loc, j_ass, metrics = body(j_loc, j_ass, jshard(mesh, {k: jnp.asarray(v) for k, v in batch.items()}), key)
        records.append({"metrics": {k: float(v) for k, v in metrics.items()}, "loc": j_loc, "ass": j_ass})
    return records


def torch_seed_for(flags, ratio=RATIO) -> int:
    """A generator seed whose successive draws keep the off-diagonals
    exactly where ``flags`` says (the port's draw: one ``torch.rand`` a
    step)."""
    for seed in range(1000):
        gen = torch.Generator().manual_seed(seed)
        if [bool(torch.rand((), generator=gen) < ratio) for _ in flags] == flags:
            return seed
    raise AssertionError(f"no seed draws {flags}")


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):  # noqa: F811
    """Every case on 2 ranks, and JAX's results for them."""
    tmp = tmp_path_factory.mktemp("parallel")
    loc, ass = port_models(weights)
    sd_loc, sd_ass = ({k: v.numpy() for k, v in m.state_dict().items()} for m in (loc, ass))
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, GLOBAL_BATCH) for _ in range(2)]
    sizes = {"img": IMG, "crop": CROP, "ch": CH, "lr": LR}

    jl_rot = jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG),
                               rotation_dropout_ratio=RATIO, sampler="rotated")
    rot_keys = [jax.random.key(k) for k in ROTATED_KEYS]

    variables = ssd_variables("SSD300", seed=6, conf_scale=1e-2, loc_scale=1e-2)
    mb_loc, mb_conf, gt_loc, gt_conf = _loss_inputs("random")
    pool_rng = np.random.default_rng(7)
    pool = {
        "scenes": pool_rng.integers(0, 256, (4, 300, 300, 3), dtype=np.uint8),
        "boxes": _boxes(pool_rng, 4, 2, 300),
        "valid": np.array([[True, True], [True, False], [True, True], [True, False]]),
    }
    ssd_key = jax.random.key(8)
    ssd_model = SSD300()
    gen = np.random.default_rng(5)
    groups = {
        "unlabeled": {"unlabeled": gen.integers(0, 256, (12, 4, 4, 3), dtype=np.uint8)},
        "reference": {"real": gen.integers(0, 256, (16, 2, 2, 3), dtype=np.uint8),
                      "labels": gen.uniform(size=(16, 1)).astype(np.float32)},
    }
    inputs = {
        "bn": bn_inputs(),
        "alternating": {"sizes": sizes, "loc": sd_loc, "ass": sd_ass, "batches": batches, "ratio": 0.0,
                        "sampler": "auto", "seed": 0},
        "alternating_rotated": {"sizes": sizes, "loc": sd_loc, "ass": sd_ass, "batches": batches, "ratio": RATIO,
                                "sampler": "rotated", "seed": torch_seed_for(ROTATED_FLAGS)},
        "draws": {"seed": 11, "n": 6},
        "ssd": {"mb_loc": mb_loc, "mb_conf": mb_conf, "gt_loc": gt_loc, "gt_conf": gt_conf,
                "weights": {k: v.numpy() for k, v in bridge.ssd_state_dict(ssd_model, variables["params"]).items()},
                "lr": SSD_LR, "draws": _numpy(jax_draws(ssd_key, 2)), "pool": pool, "batch": 2},
        "loader": {"n": 22, "batch": 6, "seed": 4},
        "suspended": {},
        "pools": {"groups": groups, "batch": 4, "k": 3, "chunks": 3, "refresh_chunks": 8,
                  "fresh": {"real": np.full((8, 2, 2, 3), 7, np.uint8), "labels": np.full((8, 1), 0.5, np.float32)}},
    }
    procs = start_workers(inputs, tmp)  # the ranks run while JAX and one process of the port do

    jl, ja = (jmodels.Localizer(out_size=JSize(CROP, CROP), n_layers=18, input_size=JSize(IMG, IMG)),
              jmodels.ResnetAssessor(ch=CH))
    jax_out = {
        "bn": {k: np.asarray(v) for k, v in bn_jax(inputs["bn"]).items()},
        "alternating": jax_alternating(jl, ja, weights, batches, [jax.random.key(0), jax.random.key(1)]),
        "alternating_rotated": jax_alternating(jl_rot, ja, weights, batches, rot_keys),
        "ssd": jax_ssd(variables, inputs["ssd"], ssd_key),
    }
    one = {case: alternating_records(inputs[case]) for case in ("alternating", "alternating_rotated")}
    outs = collect(procs, tmp)
    return {"inputs": inputs, "outs": outs, "jax": jax_out, "one": one}


def _numpy(x):
    """Tensors of a (named) tuple as numpy arrays, the tuple's type kept."""
    if isinstance(x, tuple):
        return type(x)(*(_numpy(v) for v in x))
    return x.numpy()


def jax_ssd(variables, inp, key):
    """``multibox_loss`` and its gradients on the whole batch; one step of
    ``ssd_pooled_body`` on the mesh, on one process's first chunk."""
    def loss(loc, conf):
        a, b = jmb.multibox_loss(loc, conf, jnp.asarray(inp["gt_loc"]), jnp.asarray(inp["gt_conf"]), k=3)
        return a + b, (a, b)

    (_, (j_loc, j_conf)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(inp["mb_loc"]), jnp.asarray(inp["mb_conf"]))
    mesh = mesh2()
    jmodel = jssd.SSD300()
    body = jax.jit(jsd.ssd_pooled_body(jmodel, jmodel.coder(), 300, augment=True))
    chunks = device_data.device_chunk_batches({"train": inp["pool"]}, inp["batch"], 1, seed=0, device="cpu")
    idx = next(chunks)["idx"]["train"].numpy()[0]
    chunks.close()
    batch = jshard(mesh, {k: jnp.asarray(v[idx]) for k, v in inp["pool"].items()})
    state, _, metrics = body(jreplicate(mesh, ssd_jax_state(variables["params"])), None, batch, key)
    mu = state.opt_state.inner_state[2][0].mu
    return {"loss": (float(j_loc), float(j_conf)), "grads": tuple(np.asarray(g) for g in grads), "idx": idx,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "after": jax.tree_util.tree_map(np.asarray, (state.params, mu))}


def gather(outs, case, key):
    """The ranks' rows of ``key`` of ``case``, in rank order."""
    return np.concatenate([o[case][key] for o in outs])


# -- BatchNorm -------------------------------------------------------------------------
def test_batchnorm_over_two_ranks_is_flax_s_over_the_global_batch(runs):
    outs, want = runs["outs"], runs["jax"]["bn"]
    for key in ("y", "dx"):
        assert_rel(gather(outs, "bn", key), want[key], 1e-5, key)
    for key in ("dweight", "dbias"):  # each rank's share of the global loss's gradient
        assert_rel(sum(o["bn"][key] for o in outs), want[key], 1e-6, key)
    for key in ("running_mean", "running_var"):
        for o in outs:
            np.testing.assert_allclose(o["bn"][key], want[key], rtol=1e-6, err_msg=key)
    # the local statistics alone would differ: rank 0's half has another mean
    x = runs["inputs"]["bn"]["x"]
    assert np.abs(x[:4].mean((0, 1, 2)) - x.mean((0, 1, 2))).max() > 1e-2


# -- the alternating step -------------------------------------------------------------
def _check_step(got, want, model_sd, step, mu_rtol):
    """One rank's record against JAX's after ``step`` (1 or 2)."""
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    loc_model, ass_model = model_sd
    ass_want = bridge.assessor_state_dict(ass_model, want["ass"].params)
    for k, v in ass_want.items():
        np.testing.assert_allclose(got["ass"][k], v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    loc_want = bridge.localizer_state_dict(loc_model, want["loc"].params, want["loc"].batch_stats)
    for k, v in loc_want.items():
        if "running" in k:
            assert_rel(got["loc"][k], v.numpy(), 1e-5, k)
        elif "num_batches" not in k and step == 1:
            np.testing.assert_allclose(got["loc"][k], v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    if step == 2:
        for path, value in jax_mu(want["loc"]).items():
            key, mu_j = _torch_leaf(path, np.asarray(value))
            assert_rel(got["mu"][key], mu_j, mu_rtol, key)
            delta = np.abs(got["loc"][key] - loc_want[key].numpy())
            sure = np.abs(mu_j) >= 0.1 * np.abs(mu_j).max()
            assert delta[sure].max(initial=0.0) <= 1e-6, key
            assert delta.max() <= 2 * LR, key


@pytest.mark.parametrize("case,mu_rtol", [("alternating", 3e-2), ("alternating_rotated", 5e-2)])
@pytest.mark.parametrize("step", [1, 2])
def test_alternating_step_on_two_ranks_is_jax_s_on_a_mesh(runs, weights, case, mu_rtol, step):  # noqa: F811
    models = port_models(weights)
    for out in runs["outs"]:
        _check_step(out[case][step - 1], runs["jax"][case][step - 1], models, step, mu_rtol)
    # the replicas stay equal, bit for bit, and equal one process's run at
    # the global batch to float32 rounding
    a, b = (o[case][step - 1] for o in runs["outs"])
    one = runs["one"][case][step - 1]
    for k in one["metrics"]:
        np.testing.assert_allclose(a["metrics"][k], one["metrics"][k], rtol=1e-6, err_msg=k)
    for k in one["mu"]:
        assert_rel(a["mu"][k], one["mu"][k], ONE_PROCESS_RTOL, k)
    for part in ("loc", "ass"):
        for k in a[part]:
            assert np.array_equal(a[part][k], b[part][k]), k
            if "running" in k:
                assert_rel(a[part][k], one[part][k], ONE_PROCESS_RTOL, k)
            elif "num_batches" not in k:
                delta = np.abs(a[part][k] - one[part][k])
                assert delta.max() <= 2 * step * LR, k
                if part == "loc":
                    mu = np.abs(one["mu"][k])
                    assert delta[mu >= 0.1 * mu.max()].max(initial=0.0) <= 1e-6, k


def test_rotated_run_kept_then_dropped_the_off_diagonals(runs):
    """At ratio 0.5 JAX kept the off-diagonals at step 1 (their Adam moment
    moved) and dropped them at step 2 (no gradient: the moment only
    decayed), and the ranks drew the same: the head's off-diagonal bias
    moved at step 1 (through K2's d theta)."""
    mu = [jax_mu(r["loc"])["param_predictor/bias"] for r in runs["jax"]["alternating_rotated"]]
    mu = [np.asarray(m)[[1, 3]] for m in mu]
    assert (mu[0] != 0).all()
    np.testing.assert_allclose(mu[1], np.float32(0.9) * mu[0], rtol=1e-6)
    init = runs["inputs"]["alternating_rotated"]["loc"]["param_predictor.bias"]
    after = runs["outs"][0]["alternating_rotated"][0]["loc"]["param_predictor.bias"]
    assert (init[[1, 3]] == 0).all() and (after[[1, 3]] != 0).all()


# -- the draws, the SSD loss and step ---------------------------------------------------
def test_draws_at_the_global_batch_are_one_process_s_rows(runs):
    """Each rank draws for the global batch and keeps its rows: the ranks'
    rows together are one process's draws, and the generators stay in step."""
    inp = runs["inputs"]["draws"]
    gen = torch.Generator().manual_seed(inp["seed"])
    crops = torch.zeros(inp["n"], 2, 2, 3)
    want = {"flips": draw_flips(gen, crops), "jitter": tuple(draw_jitter(gen, crops)),
            "ssd": tuple(sd.draw_ssd_augment(gen, crops)), "after": torch.rand(3, generator=gen)}
    outs = [o["draws"] for o in runs["outs"]]
    assert np.array_equal(np.concatenate([o["flips"] for o in outs]), want["flips"].numpy())
    for part in ("jitter", "ssd"):
        for i, w in enumerate(want[part]):
            if isinstance(w, tuple):  # the SSD draws' jitter
                for j, wj in enumerate(w):
                    assert np.array_equal(np.concatenate([o[part][i][j] for o in outs]), wj.numpy())
            else:
                assert np.array_equal(np.concatenate([o[part][i] for o in outs]), w.numpy()), (part, i)
    for o in outs:
        assert np.array_equal(o["after"], want["after"].numpy())


def test_multibox_loss_counts_the_global_positives(runs):
    outs, want = runs["outs"], runs["jax"]["ssd"]
    got = np.mean([o["ssd"]["loss"] for o in outs], axis=0)
    np.testing.assert_allclose(got, want["loss"], rtol=1e-6)
    # each rank's gradient is W times its rows of the global loss's gradient
    for key, w in zip(("d_loc", "d_conf"), want["grads"]):
        got = gather(outs, "ssd", key) / WORLD
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=key)
        assert np.array_equal(got != 0, np.asarray(w) != 0)
    assert [int((o["ssd"]["d_conf"] != 0).any(-1).sum()) for o in outs] != [0, 0]


def test_ssd_step_on_two_ranks_is_jax_s_on_a_mesh(runs):
    outs, want = runs["outs"], runs["jax"]["ssd"]
    # the ranks took the columns of the chunk JAX trained on
    assert np.array_equal(np.concatenate([o["ssd"]["idx"][0] for o in outs]), want["idx"])
    for o in outs:
        for k in ("loss", "loss/loc", "loss/conf"):
            np.testing.assert_allclose(o["ssd"]["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    model = SSD300()
    for o in outs:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in o["ssd"]["params"].items()})
        _hold_params(model, ssd_variables("SSD300", seed=6, conf_scale=1e-2, loc_scale=1e-2), want["after"], 1)


# -- device pools ------------------------------------------------------------------------
def test_device_chunks_at_two_ranks_are_one_process_s_columns(runs):
    inp = runs["inputs"]["pools"]
    one = device_data.device_chunk_batches(inp["groups"], inp["batch"], inp["k"], seed=3, device="cpu")
    for c in range(inp["chunks"]):
        chunk = next(one)
        for g in inp["groups"]:
            got = np.concatenate([o["pools"]["columns"][c][g] for o in runs["outs"]], axis=1)
            assert np.array_equal(got, chunk["idx"][g].numpy()), (c, g)
    one.close()


def test_refresh_swaps_at_the_same_chunk_on_every_rank(runs):
    """Rank 0 alone calls the factory; the ranks swap at the same chunk to
    the same pool and go on drawing the same streams."""
    outs = [o["pools"] for o in runs["outs"]]
    assert outs[0]["calls"] and not outs[1]["calls"]
    fresh = runs["inputs"]["pools"]["fresh"]["labels"]
    swapped = [[bool(np.array_equal(s["labels"], fresh)) for s in o["seen"]] for o in outs]
    assert swapped[0] == swapped[1] and any(swapped[0]) and not swapped[0][0]
    for a, b in zip(*(o["seen"] for o in outs)):
        assert np.array_equal(a["labels"], b["labels"])
        assert a["idx"].shape == b["idx"].shape == (3, 2)


# -- the host loader ---------------------------------------------------------------------
def test_loader_hands_each_rank_its_slice_and_loads_nothing_else(runs):
    """``DataLoader(shard=True)`` at the global batch 6 on 2 ranks: every
    rank draws one process's order and loads only its 3 of each batch."""
    from loans_tpu_torch.data.loader import DataLoader
    from torch_parallel_worker import CountingDataset

    inp = runs["inputs"]["loader"]
    ds = CountingDataset(inp["n"])
    want = [b[:, 0] for seed in (inp["seed"], inp["seed"] + 1)
            for b in DataLoader(ds, inp["batch"], shuffle=True, repeat=False, seed=seed, num_workers=2)]
    outs = [o["loader"] for o in runs["outs"]]
    assert len(want) == 2 * (inp["n"] // inp["batch"])
    for i, batch in enumerate(want):
        assert np.array_equal(np.concatenate([o["batches"][i] for o in outs]), batch)
    for o in outs:
        assert o["loaded"] == sorted(np.concatenate(o["batches"]).tolist())
        assert len(o["loaded"]) == len(want) * inp["batch"] // WORLD


def test_suspended_holds_for_the_calling_thread_only(runs):
    """Rank 0's evaluation suspends the group for its own thread; the
    threads that feed training meanwhile still see both ranks."""
    for o in runs["outs"]:
        assert o["suspended"] == {"here": 1, "other": WORLD, "after": WORLD}
