"""The five readers of the program's spans on a made-up trace whose spans
and runtime calls are known: their exact values, a synchronising call
outside every span left uncounted, and ``None`` where the program has no
``loans.`` span or the run is off the card."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spans, trace


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(events):
    return trace.Trace.from_chrome({"traceEvents": [_event("user_annotation", trace.SPAN, 0, 1000)] + events})


TRAIN = [
    # call 1: the feed (100 us, with a pageable upload: copy 10 + sync 20), then the call (300 us)
    _event("user_annotation", "loans.feed", 0, 100),
    _event("cuda_runtime", "cudaMemcpyAsync", 40, 10),
    _event("cuda_runtime", "cudaStreamSynchronize", 50, 20),
    _event("user_annotation", "loans.train.call", 100, 300),
    _event("user_annotation", "loans.train.step", 100, 150),  # nested: counted once
    _event("cuda_runtime", "cudaLaunchKernel", 110, 5),  # neither a sync nor a copy
    _event("cuda_runtime", "cudaMemcpyAsync", 200, 30),
    _event("cuda_runtime", "cudaStreamSynchronize", 230, 40),
    _event("cuda_runtime", "cudaDeviceSynchronize", 390, 20),  # starts inside, ends outside: 10 us inside
    # call 2
    _event("user_annotation", "loans.feed", 500, 50),
    _event("user_annotation", "loans.train.call", 550, 250),
    _event("cuda_runtime", "cudaEventSynchronize", 600, 10),
    # outside every span: the benchmark's own sync after the stretch
    _event("cuda_runtime", "cudaDeviceSynchronize", 900, 50),
    _event("cuda_runtime", "cudaMemcpyAsync", 960, 10),
]

SERVE = [
    _event("user_annotation", "loans.serve.batch", 0, 200),
    _event("user_annotation", "loans.serve.upload", 0, 50),
    _event("cuda_runtime", "cudaMemcpyAsync", 10, 20),
    _event("cuda_runtime", "cudaStreamSynchronize", 30, 10),
    _event("user_annotation", "loans.serve.download", 150, 50),
    _event("cuda_runtime", "cudaMemcpyAsync", 150, 40),  # a copy that waits for the device
    _event("cuda_runtime", "cudaStreamSynchronize", 190, 5),
    _event("user_annotation", "loans.serve.batch", 300, 100),
    _event("cuda_runtime", "cudaStreamSynchronize", 350, 10),
    _event("cuda_runtime", "cudaStreamSynchronize", 500, 10),  # between batches
]


def _ctx(events, units, device="cuda"):
    return SimpleNamespace(trace_data=_trace(events), traced_units=units, device=torch.device(device))


def _read(metric, ctx):
    return harness.load_module("metrics", metric).read(ctx)


def test_training_readers_exact():
    ctx = _ctx(TRAIN, {"calls": 2, "steps": 4})
    # feed: 100 + 50 us over 4 steps
    assert _read("feed_ms.train", ctx) == pytest.approx(150e-3 / 4)
    # calls: 300 + 250 us, less the copy 30 + sync 40 + 10 of the device sync + the event sync 10
    assert _read("host_ms.train", ctx) == pytest.approx((550 - 90) * 1e-3 / 4)
    # syncs starting in the feed (1) or a call (3); the one at 900 us is outside
    assert _read("syncs_per_step.train", ctx) == pytest.approx(4 / 4)


def test_serving_readers_exact():
    ctx = _ctx(SERVE, {"batches": 2})
    # 300 us of batches less copies and syncs: 20 + 10 + 40 + 5 + 10
    assert _read("host_ms.serve", ctx) == pytest.approx((300 - 85) * 1e-3 / 2)
    assert _read("syncs_per_batch.serve", ctx) == pytest.approx(3 / 2)


def test_a_sync_outside_every_span_is_not_counted():
    ctx = _ctx([TRAIN[0], _event("cuda_runtime", "cudaStreamSynchronize", 150, 10),
                _event("cuda_runtime", "cudaStreamSynchronize", 50, 10)], {"steps": 1})
    assert _read("syncs_per_step.train", ctx) == 1


@pytest.mark.parametrize("metric", ["feed_ms.train", "host_ms.train", "syncs_per_step.train",
                                    "host_ms.serve", "syncs_per_batch.serve"])
def test_no_program_span_reads_none(metric):
    plain = [e for e in TRAIN + SERVE if e["cat"] != "user_annotation"]
    assert _read(metric, _ctx(plain, {"steps": 4, "batches": 2})) is None
    assert _read(metric, _ctx(TRAIN + SERVE, {"steps": 4, "batches": 2}, device="cpu")) is None


def test_overlap_of_interval_lists():
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], []) == 0
    assert spans.overlap([(0, 10)], [(0, 2), (3, 4), (9, 12)]) == 4
