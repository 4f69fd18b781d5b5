"""Device data of the training CLI against the JAX package: the eval
batches, the pool refresh and its reseeded index stream, and the launch
counters that a refresh thread and the training thread share.

The refresh factory records the generations it is called with and
returns at once; the test pulls chunks until the swap shows, as training
would, and then holds the swapped group's index stream to JAX's
``IndexSampler`` at the reseeded seed ``seed + j + 7919 * generation``.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from loans_tpu.data import device_data as jdata
from loans_tpu.parallel import create_mesh
from loans_tpu_torch.data import device_data
from loans_tpu_torch.ops import stn


class LabeledSet:
    """(image, gt boxes, score) examples, as a labeled val set gives them."""

    def __init__(self, n, size=8, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        self.boxes = rng.uniform(0, size, (n, 1, 4)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.boxes[i], np.zeros((1,), np.float32)


def test_device_eval_batches_match_jax():
    ds = LabeledSet(11)
    got = device_data.device_eval_batches(ds, 4, device="cpu")
    want = jdata.device_eval_batches(create_mesh(), ds, 4)
    assert len(got) == len(want) == 2  # the partial tail is dropped
    for g, w in zip(got, want):
        assert isinstance(g[0], torch.Tensor) and g[0].dtype == torch.uint8
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        assert isinstance(g[1], np.ndarray)  # the ground truth stays on the host
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_pool_refresh_swaps_and_reseeds_like_jax():
    rng = np.random.default_rng(0)
    groups = {
        "unlabeled": {"unlabeled": rng.integers(0, 256, (12, 4, 4, 3), dtype=np.uint8)},
        "reference": {"real": rng.integers(0, 256, (10, 2, 2, 3), dtype=np.uint8),
                      "labels": rng.uniform(size=(10, 1)).astype(np.float32)},
    }
    calls = []
    returned = threading.Event()

    def factory(generation):
        calls.append(generation)
        pool = {"real": np.full((9, 2, 2, 3), generation, np.uint8),
                "labels": np.full((9, 1), generation, np.float32)}
        returned.set()
        return pool

    batch, k, seed, every = 3, 2, 5, 2
    swaps0 = device_data.device_chunk_batches.swaps
    chunks = device_data.device_chunk_batches(
        groups, batch, k, seed=seed, device="cpu", refresh={"reference": (factory, every)})
    taken = [next(chunks) for _ in range(every + 1)]  # chunk 2 submits generation 1
    assert returned.wait(timeout=30) and calls == [1]
    for _ in range(1000):  # the swap lands at the first chunk after the call returns
        chunk = next(chunks)
        taken.append(chunk)
        if device_data.device_chunk_batches.swaps > swaps0:
            break
        time.sleep(0.005)
    assert device_data.device_chunk_batches.swaps == swaps0 + 1
    assert chunk["pools"]["reference"]["real"].shape[0] == 9
    assert float(chunk["pools"]["reference"]["labels"][0, 0]) == 1.0
    # the swapped group restarts its stream at seed + j + 7919 * generation
    # (j = 1: the second group); the other group's stream runs on
    sampler = jdata.IndexSampler(9, batch, seed=seed + 1 + 7919 * 1).epochs()
    want = np.stack([next(sampler) for _ in range(k)])
    np.testing.assert_array_equal(chunk["idx"]["reference"].numpy(), want)
    unlabeled = jdata.IndexSampler(12, batch, seed=seed).epochs()
    for c in taken:
        np.testing.assert_array_equal(c["idx"]["unlabeled"].numpy(), np.stack([next(unlabeled) for _ in range(k)]))
    # the next submission waits for `every` chunks; closing waits for a
    # running call and returns
    chunks.close()
    assert calls == [1] or calls == [1, 2]


def test_refresh_call_is_not_waited_for_by_training():
    """A slow factory does not hold chunks back; the pool swaps when it
    returns, and closing the stream waits for it."""
    release = threading.Event()

    def factory(generation):
        release.wait(timeout=30)
        return {"x": np.full((4, 1), generation, np.float32)}

    chunks = device_data.device_chunk_batches(
        {"g": {"x": np.zeros((4, 1), np.float32)}}, 2, 1, device="cpu", refresh={"g": (factory, 1)})
    seen = [float(next(chunks)["pools"]["g"]["x"][0, 0]) for _ in range(20)]
    assert seen == [0.0] * 20
    release.set()
    chunks.close()


def test_a_failed_refresh_raises():
    """A factory's error is not lost: it raises from the chunk that would
    have swapped, or from closing the stream."""
    def factory(generation):
        raise ValueError(f"generation {generation} failed")

    group = {"g": {"x": np.zeros((4, 1), np.float32)}}
    chunks = device_data.device_chunk_batches(group, 2, 1, device="cpu", refresh={"g": (factory, 1)})
    with pytest.raises(ValueError, match="generation 1 failed"):
        for _ in range(1000):
            next(chunks)
            time.sleep(0.005)
    chunks = device_data.device_chunk_batches(group, 2, 1, device="cpu", refresh={"g": (factory, 1)})
    next(chunks), next(chunks)  # chunk 1 submits
    with pytest.raises(ValueError, match="generation 1 failed"):
        chunks.close()


class _FakeLib:
    def __init__(self):
        self.fake_entry = lambda *args: 0


def test_launch_counter_holds_under_threads(monkeypatch):
    """Two threads launch at once on the card when the pool refresh renders
    its crops beside training: no count may be lost. 16 threads, 2000
    launches each, with a switch interval of 1 us."""
    lib = _FakeLib()
    monkeypatch.setattr(stn._cuda, "load_library", lambda name: lib)

    class Owner:
        launches = 0

    def work():
        for _ in range(2000):
            stn._launch("fake", "fake_entry", Owner, "launches")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert Owner.launches == 16 * 2000


def test_refresh_rejects_nothing_without_refresh():
    chunks = device_data.device_chunk_batches({"g": {"x": np.zeros((4, 1), np.float32)}}, 2, 3, device="cpu")
    chunk = next(chunks)
    assert chunk["idx"]["g"].shape == (3, 2)
    chunks.close()
    with pytest.raises(StopIteration):
        next(chunks)
