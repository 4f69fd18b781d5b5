"""Replication, batch sharding and the collectives of data-parallel
training (port of ``loans_tpu/parallel/mesh.py``).

The JAX package replicates the parameters over a mesh and shards the batch
on its ``data`` axis; XLA then inserts the gradient all-reduce and turns
BatchNorm's batch mean into an all-reduce. Here each process holds a
replica and its slice of the batch, and these functions are those
collectives, each a no-op at world size 1 or inside
``distributed.suspended()``. Tensors of one dtype travel in one flat
buffer (a bucket), so a state's gradients are one all-reduce.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from loans_tpu_torch.parallel.distributed import data_parallel_size, local_batch_slice, world_size


def _buckets(tensors: Iterable[torch.Tensor]) -> dict[tuple, list[torch.Tensor]]:
    out: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def replicate(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank ``src``, in
    place: every rank then holds rank ``src``'s replica."""
    if world_size() == 1:
        return module
    with torch.no_grad():
        tensors = list(module.parameters()) + list(module.buffers())
        for bucket in _buckets(tensors).values():
            flat = _flatten_dense_tensors(bucket)
            dist.broadcast(flat, src)
            for t, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                t.copy_(v)
    return module


def shard_batch(batch: Any) -> Any:
    """This rank's slice of a global batch: every array or tensor leaf of
    a (nested tuple, named tuple, list or dict) batch cut on its leading
    axis."""
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch(b) for b in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b) for b in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v) for k, v in batch.items()}
    start, size = local_batch_slice(len(batch))
    return batch[start : start + size]


def local_rows(x: torch.Tensor, n_local: int) -> torch.Tensor:
    """The rows of this rank from ``x``, drawn for the global batch of
    ``n_local * data_parallel_size()`` rows (the draws of one process at
    that batch)."""
    start = local_batch_slice(n_local * data_parallel_size())[0]
    return x[start : start + n_local]


def all_reduce_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average the parameters' ``.grad`` over the ranks, in place: the
    all-reduce XLA inserts for the JAX package. A parameter without a
    gradient counts as a zero gradient (as the optimizers count it)."""
    n = data_parallel_size()
    if n == 1:
        return
    params = list(params)
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    for bucket in _buckets(grads).values():
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat)
        flat.div_(n)
        for g, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(v)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, outside autograd."""
    if data_parallel_size() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the global batch of NCHW ``x``
    (its local slice on each rank). Forward: one all-reduce of the
    per-channel sum, sum of squares and count; flax's biased variance
    E[x²] - E[x]², clipped at 0. Backward: one all-reduce of the sums of
    dy and dy·x̂, and the centered form dx = w·rstd·(dy - Σdy/n -
    x̂·Σ(dy·x̂)/n), where autodiff of E[x²] - E[x]² would subtract terms
    of the size of the mean. d weight and d bias stay this rank's share:
    the gradient all-reduce averages them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                           x.new_full((1,), float(x.numel() // c))])
        dist.all_reduce(stats)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c : 2 * c] / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        xhat = (x - mean[None, :, None, None]) * rstd[None, :, None, None]
        y = xhat * weight[None, :, None, None] + bias[None, :, None, None]
        ctx.save_for_backward(xhat, weight, rstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, rstd, n = ctx.saved_tensors
        c = xhat.shape[1]
        d_bias = dy.sum(dim=(0, 2, 3))
        d_weight = (dy * xhat).sum(dim=(0, 2, 3))
        sums = torch.cat([d_bias, d_weight])
        dist.all_reduce(sums)
        dx = (dy - (sums[:c] / n)[None, :, None, None] - xhat * (sums[c:] / n)[None, :, None, None]) \
            * (weight * rstd)[None, :, None, None]
        return dx, d_weight, d_bias, None


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, biased variance) of train-mode batch normalization of
    NCHW ``x`` over the global batch, differentiable in ``x``, ``weight``
    and ``bias`` (``_GlobalBatchNorm``)."""
    return _GlobalBatchNorm.apply(x, weight, bias, eps)


def reduce_metrics(pending: list[dict[str, torch.Tensor]]) -> list[dict[str, float]]:
    """Each rank's metric dicts (0-d tensors, the same keys in the same
    order on every rank) as host floats, averaged over the ranks in one
    all-reduce: a metric that is a mean over a rank's equal share of the
    batch becomes the mean over the global batch."""
    if not pending:
        return []
    keys = [list(m) for m in pending]
    flat = torch.stack([m[k].float() for m, ks in zip(pending, keys) for k in ks])
    n = data_parallel_size()
    if n > 1:
        dist.all_reduce(flat)
        flat = flat / n
    values = iter(flat.tolist())
    return [{k: next(values) for k in ks} for ks in keys]
