"""One rank of the data-parallel tests: a gloo process on the CPU that
runs the port only (no JAX), for ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py <rank> <world> <init_method> <dir>

Reads ``<dir>/in.pt``, a dict ``case -> inputs`` (numpy arrays and
state dicts, global batches), joins the group with the explicit
``init_method``, rank and world size, runs every case in the dict's order
on this rank's slice and writes ``<dir>/out<rank>.pt``, ``case ->
outputs``.
"""

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from loans_tpu_torch import parallel  # noqa: E402
from loans_tpu_torch.data import device_data  # noqa: E402
from loans_tpu_torch.data import ssd_device as sd  # noqa: E402
from loans_tpu_torch.data.device_augment import draw_flips, draw_jitter  # noqa: E402
from loans_tpu_torch.models import SSD300, Localizer, ResnetAssessor  # noqa: E402
from loans_tpu_torch.models.resnet import batch_norm  # noqa: E402
from loans_tpu_torch.ops.geometry import Size  # noqa: E402
from loans_tpu_torch.ops.multibox import multibox_loss  # noqa: E402
from loans_tpu_torch.train import AlternatingConfig, TrainState, alternating_step, create_train_state, pooled_step  # noqa: E402,E501
from loans_tpu_torch.train.ssd_steps import SSDAdam  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_torch(v) for v in tree)) if hasattr(tree, "_fields") else tuple(map(to_torch, tree))
    return torch.from_numpy(np.asarray(tree))


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(numpy_tree(v) for v in tree)
    return tree.detach().numpy().copy() if isinstance(tree, torch.Tensor) else tree


@case
def bn(inp):
    """The port's BatchNorm2d in train mode on this rank's half of an
    NHWC batch; the loss sum(y * g)."""
    m = batch_norm(inp["x"].shape[-1])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, k).copy_(torch.from_numpy(inp[k]))
    x = parallel.shard_batch(torch.from_numpy(inp["x"])).permute(0, 3, 1, 2).requires_grad_(True)
    g = parallel.shard_batch(torch.from_numpy(inp["g"])).permute(0, 3, 1, 2)
    y = m.train()(x)
    (y * g).sum().backward()
    return numpy_tree({"y": y.permute(0, 2, 3, 1), "dx": x.grad.permute(0, 2, 3, 1), "dweight": m.weight.grad,
                       "dbias": m.bias.grad, "running_mean": m.running_mean, "running_var": m.running_var})


def alternating_records(inp):
    """Alternating steps on this rank's slice of each global batch (one
    process: the whole batch); a record after each step."""
    s = inp["sizes"]
    loc = Localizer(out_size=Size(s["crop"], s["crop"]), n_layers=18, input_size=Size(s["img"], s["img"]),
                    rotation_dropout_ratio=inp["ratio"], sampler=inp["sampler"])
    loc.load_state_dict(to_torch(inp["loc"]))
    ass = ResnetAssessor(ch=s["ch"], in_size=Size(s["crop"], s["crop"]))
    ass.load_state_dict(to_torch(inp["ass"]))
    loc_s, ass_s = create_train_state(loc, s["lr"]), create_train_state(ass, s["lr"])
    gen = torch.Generator().manual_seed(inp["seed"])
    config = AlternatingConfig(image_size=Size(s["img"], s["img"]))
    records = []
    for batch in inp["batches"]:
        loc_s, ass_s, metrics = alternating_step(loc_s, ass_s, parallel.shard_batch(to_torch(batch)), gen, config)
        records.append({
            "metrics": parallel.reduce_metrics([metrics])[0],
            "loc": numpy_tree(dict(loc.state_dict())),
            "ass": numpy_tree(dict(ass.state_dict())),
            "mu": numpy_tree({n: loc_s.optimizer.state[p]["mu"] for n, p in loc.named_parameters()}),
        })
    return records


CASES["alternating"] = CASES["alternating_rotated"] = alternating_records


@case
def draws(inp):
    """The step's random draws at this rank's batch from a generator seeded
    as one process's: the flips and jitter of the reference crops, then
    the SSD augmentation's."""
    gen = torch.Generator().manual_seed(inp["seed"])
    crops = torch.zeros(inp["n"] // parallel.world_size(), 2, 2, 3)
    return numpy_tree({"flips": draw_flips(gen, crops), "jitter": tuple(draw_jitter(gen, crops)),
                       "ssd": tuple(sd.draw_ssd_augment(gen, crops)),
                       "after": torch.rand(3, generator=gen)})


@case
def ssd(inp):
    """multibox_loss and its gradient on this rank's rows; then one SSD
    step on this rank's columns of a pool chunk, with the given global
    draws cut to this rank's rows."""
    mb_loc, mb_conf = (parallel.shard_batch(torch.from_numpy(inp[k])).requires_grad_(True)
                       for k in ("mb_loc", "mb_conf"))
    gt_loc, gt_conf = (parallel.shard_batch(torch.from_numpy(inp[k])) for k in ("gt_loc", "gt_conf"))
    loc_loss, conf_loss = multibox_loss(mb_loc, mb_conf, gt_loc, gt_conf)
    (loc_loss + conf_loss).backward()
    out = {"loss": numpy_tree((loc_loss, conf_loss)), "d_loc": mb_loc.grad.numpy(), "d_conf": mb_conf.grad.numpy()}

    model = SSD300()
    model.load_state_dict(to_torch(inp["weights"]))
    state = TrainState(model=model.train(), optimizer=SSDAdam(model, lr=inp["lr"]))
    draws = parallel.shard_batch(to_torch(inp["draws"]))
    sd.draw_ssd_augment = lambda generator, scenes: draws
    chunk = next(device_data.device_chunk_batches({"train": inp["pool"]}, inp["batch"], 1, seed=0, device="cpu"))
    body = sd.SSDPooledBody(model.coder(), 300, augment=True)
    state, _, metrics = pooled_step(state, None, chunk, None, steps_per_call=1, body=body)
    out["idx"] = chunk["idx"]["train"].numpy()
    out["metrics"] = parallel.reduce_metrics([metrics])[0]
    out["params"] = numpy_tree(dict(model.state_dict()))
    return out


@case
def pools(inp):
    """Index columns of device_chunk_batches without a refresh; then a
    refresh whose factory rank 0 would finish late and rank 1 at once."""
    groups, batch, k = inp["groups"], inp["batch"], inp["k"]
    plain = device_data.device_chunk_batches(groups, batch, k, seed=3, device="cpu")
    columns = [{g: c["idx"][g].numpy() for g in groups} for c in (next(plain) for _ in range(inp["chunks"]))]
    plain.close()
    calls = []

    def factory(generation):
        calls.append(generation)
        time.sleep(0.4 if parallel.rank() == 0 else 0.0)
        return inp["fresh"]

    refreshed = device_data.device_chunk_batches(groups, batch, k, seed=3, device="cpu",
                                                 refresh={"reference": (factory, 1)})
    seen = []
    for chunk_i in range(inp["refresh_chunks"]):
        chunk = next(refreshed)
        seen.append({"labels": chunk["pools"]["reference"]["labels"].numpy().copy(),
                     "idx": chunk["idx"]["reference"].numpy()})
        time.sleep(0.15 if parallel.rank() == 0 else 0.02)
    refreshed.close()
    return {"columns": columns, "seen": seen, "calls": calls}


@case
def suspended(inp):
    """The world size the data-parallel math sees inside
    ``parallel.suspended()``, in this thread and meanwhile in another
    (the loader's and the refresh's threads keep the group), and after."""
    seen = {}
    with parallel.suspended():
        other = threading.Thread(target=lambda: seen.update(other=parallel.data_parallel_size()))
        other.start()
        other.join(timeout=30)
        seen["here"] = parallel.data_parallel_size()
    seen["after"] = parallel.data_parallel_size()
    return seen


class CountingDataset:
    """Example i is i; ``loaded`` lists every index loaded."""

    def __init__(self, n):
        self.n = n
        self.loaded = []

    def __len__(self):
        return self.n

    def get_example(self, i):
        self.loaded.append(i)
        return np.array([i])


@case
def loader(inp):
    """Two shuffled epochs of a ``DataLoader(shard=True)`` at the global
    batch: this rank's batches and every index it loaded."""
    from loans_tpu_torch.data.loader import DataLoader

    ds = CountingDataset(inp["n"])
    batches = [b[:, 0] for b in DataLoader(ds, inp["batch"], shuffle=True, repeat=False, seed=inp["seed"],
                                             num_workers=2, shard=True)]
    batches += [b[:, 0] for b in DataLoader(ds, inp["batch"], shuffle=True, repeat=False, seed=inp["seed"] + 1,
                                              num_workers=2, shard=True)]
    return {"batches": batches, "loaded": sorted(ds.loaded)}


def main():
    rank, world, init_method, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)
    parallel.init_distributed(backend="gloo", init_method=init_method, world_size=world, rank=rank,
                              device_type="cpu", timeout=120)
    try:
        inputs = torch.load(os.path.join(io, "in.pt"), weights_only=False)
        out = {}
        for name, inp in inputs.items():
            start = time.perf_counter()
            out[name] = CASES[name](inp)
            out[name + "_seconds"] = time.perf_counter() - start
        torch.save(out, os.path.join(io, f"out{rank}.pt"))
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
