"""A data-parallel dry run (counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m loans_tpu_torch.parallel.dryrun --processes 2               # on the GPUs
    python -m loans_tpu_torch.parallel.dryrun --processes 2 --device cpu  # on the CPU

Spawns N processes joined by an explicit ``init_method``, rank and world
size: on the CPU over gloo; on CUDA, rank r on GPU r mod the GPU count,
over NCCL where every rank has a GPU of its own and over gloo where ranks
share one (NCCL refuses two ranks on one GPU). Each replicates the R-18
localizer (64²→16²) and the ResnetAssessor (ch 8), takes its columns of
one device-pool chunk at the global batch 2·N and runs one alternating
step through ``pooled_step``: BatchNorm over the global batch, the
gradient all-reduce, the metrics reduced over the ranks. Rank 0 prints the metrics and whether every
rank's parameters and BatchNorm statistics equal rank 0's afterwards;
the exit code is 0 when they do.
"""

from __future__ import annotations

import argparse
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

IMG, CROP, CH = 64, 16, 8


def free_port() -> int:
    """A free TCP port on localhost (for ``tcp://127.0.0.1:<port>``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def max_difference_from_rank0(modules) -> float:
    """The largest |x - rank 0's x| over the modules' parameters and
    buffers, over every rank."""
    tensors = [t.detach().float().reshape(-1) for m in modules for t in (*m.parameters(), *m.buffers())]
    flat = torch.cat(tensors)
    ref = flat.clone()
    dist.broadcast(ref, 0)
    diff = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(diff, op=dist.ReduceOp.MAX)
    return float(diff)


def worker(rank: int, world: int, init_method: str, threads: int, device: str) -> None:
    from loans_tpu_torch import parallel
    from loans_tpu_torch.data.device_data import device_chunk_batches
    from loans_tpu_torch.models import Localizer, ResnetAssessor
    from loans_tpu_torch.ops.geometry import Size
    from loans_tpu_torch.train import AlternatingConfig, create_train_state, pooled_step

    torch.set_num_threads(threads)
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if world <= cards else "gloo"
    parallel.init_distributed(backend=backend, init_method=init_method, world_size=world, rank=rank,
                              device_type=dev.type, timeout=300)
    try:
        torch.manual_seed(rank)  # different on every rank: replicate must make them equal
        loc = Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG)).to(dev)
        ass = ResnetAssessor(ch=CH, in_size=Size(CROP, CROP)).to(dev)
        for m in (loc, ass):
            parallel.replicate(m)
        loc_state, ass_state = create_train_state(loc), create_train_state(ass)
        gen = np.random.default_rng(0)
        batch = 2 * world
        groups = {
            "unlabeled": {"unlabeled": gen.integers(0, 256, (2 * batch, IMG, IMG, 3), dtype=np.uint8)},
            "reference": {"real": gen.integers(0, 256, (2 * batch, CROP, CROP, 3), dtype=np.uint8),
                          "labels": gen.uniform(size=(2 * batch, 1)).astype(np.float32)},
        }
        chunks = device_chunk_batches(groups, batch, 1, seed=0, device=dev)
        _, _, metrics = pooled_step(loc_state, ass_state, next(chunks), torch.Generator(dev).manual_seed(1),
                                    steps_per_call=1, config=AlternatingConfig(image_size=Size(IMG, IMG)))
        chunks.close()
        reduced = parallel.reduce_metrics([metrics])[0]
        diff = max_difference_from_rank0([loc, ass])
        if rank == 0:
            print(f"dryrun: {world} processes ({backend} on {dev.type}), global batch {batch}, "
                  + ", ".join(f"{k} {v:.6g}" for k, v in reduced.items()))
            print(f"dryrun: parameters and BatchNorm statistics agree across ranks: {diff == 0.0} "
                  f"(largest difference from rank 0: {diff:.3g})")
        if diff != 0.0 or not all(np.isfinite(v) for v in reduced.values()):
            raise SystemExit(1)
    finally:
        parallel.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one data-parallel alternating step over N processes")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--threads", type=int, default=2, help="torch threads per process")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.spawn(worker, args=(args.processes, init_method, args.threads, args.device), nprocs=args.processes,
             join=True)


if __name__ == "__main__":
    sys.exit(main())
