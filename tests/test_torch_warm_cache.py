"""The synthetic cache of the port (``data.synthetic.cached_synthetic``) and
its warming tool (``cli.warm_cache``) on the CPU at 64².

* Two processes that miss the same entry at once (the ranks of a
  ``torchrun`` run on a cold cache) both succeed, and the entry reads back.
* ``cli.warm_cache`` refuses to run without ``--synthetic-cache``; a cache
  it warmed is hit by a later ``cli.train_localizer.main`` run, which then
  generates nothing and trains on the arrays a cold build makes.
* The port's tool and the JAX package's ``tools/warm_cache.py`` (run in a
  subprocess: importing it sets ``LOANS_PLATFORM``), warmed from one set of
  flags in two directories, write the same file names. With ``pil`` every
  column is equal bit for bit. With ``stn`` the scenes and the IoU labels
  are equal, and the crops, rendered by each package's sampler (the port's
  plain version on the CPU, JAX's jitted one) with float32 sums in another
  order, may round to the other uint8 value where a float lies within
  rounding of a .5 boundary: one step on at most 1e-3 of the pixels, as
  ``test_torch_synthetic.py`` holds the renders. The files are compared
  with ``np.load``: npz members carry timestamps.
"""

import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest

from loans_tpu_torch.cli import train_localizer, warm_cache
from loans_tpu_torch.data import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_ARGV = ["synthetic:12", "synthetic:40", "synthetic:8", "--target-size", "64", "64", "--crop-size", "16", "16",
             "--synthetic-assets", "4", "--seed", "3"]
TRAIN_ARGV = ["--batch-size", "8", "--n-layers", "18", "--steps-per-call", "2", "--iterations", "2",
              "--log-interval", "2", "--eval-batches", "1"]
RENDER_TOL = {"steps": 1, "share": 1e-3}


def load_entry(path: str) -> list[np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return [z[f"col{i}"] for i in range(int(z["ncols"]))]


def entries(cache_dir) -> dict[str, list[np.ndarray]]:
    return {name: load_entry(os.path.join(cache_dir, name)) for name in sorted(os.listdir(cache_dir))}


# -- two writers of one entry at once ------------------------------------------------
class Items:
    def __init__(self, items):
        self.items = items


ENTRY = {"n": 3, "kind_of_test": "concurrent"}
ROWS, ROW_BYTES = 3, 8 << 20


def rows() -> list:
    return [(np.full(ROW_BYTES, i, np.uint8), float(i)) for i in range(ROWS)]


def write_at_once(cache_dir: str, barrier) -> None:
    """A miss of ``ENTRY`` whose build waits for the other process's, so
    that both write the entry together."""
    def build(items):
        if items is not None:
            return Items(items)
        out = Items(rows())
        barrier.wait(timeout=120)
        return out

    synthetic.cached_synthetic(cache_dir, "crops", build, **ENTRY)


def test_two_processes_write_one_entry_at_once(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    procs = [ctx.Process(target=write_at_once, args=(str(tmp_path), barrier)) for _ in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    # one entry and no temporary file left, the rows of either writer
    assert os.listdir(tmp_path) == [synthetic._cache_key("crops", **ENTRY)]
    cols = load_entry(os.path.join(tmp_path, synthetic._cache_key("crops", **ENTRY)))
    want = list(zip(*rows()))
    np.testing.assert_array_equal(cols[0], np.stack(want[0]))
    np.testing.assert_array_equal(cols[1], np.asarray(want[1]))
    os.remove(os.path.join(tmp_path, synthetic._cache_key("crops", **ENTRY)))  # 24 MiB


# -- the port's tool -----------------------------------------------------------------------
def test_warm_cache_refuses_without_a_cache_dir(tmp_path):
    with pytest.raises(SystemExit, match="--synthetic-cache is required"):
        warm_cache.main(DATA_ARGV + ["--device", "cpu"])


def test_a_warmed_cache_serves_the_training_cli(tmp_path, monkeypatch, capsys):
    """``warm_cache`` with ``stn`` crops rendered on the CPU, then the
    training CLI with the same flags: every split is read from the cache
    (no ``build`` generates, no crop is rendered), and the arrays it
    trains on are a cold build's."""
    argv = DATA_ARGV + ["--assessor-pipeline", "stn", "--device", "cpu"]
    cache = str(tmp_path / "cache")
    warmed = warm_cache.main(argv + ["--synthetic-cache", cache])
    out = capsys.readouterr().out
    assert "warmed cache in " in out and f"train=12 reference=40 val=8 -> {cache}" in out
    assert len(os.listdir(cache)) == 3

    built, used = [], []
    cached = synthetic.cached_synthetic

    def spy(cache_dir, kind, build, **kw):
        def recorded(items):
            built.append(items is None)
            return build(items=items)
        used.append(cached(cache_dir, kind, recorded, **kw))
        return used[-1]

    monkeypatch.setattr(synthetic, "cached_synthetic", spy)
    renders = synthetic.render_stn_crops.batches
    log_dir = train_localizer.main(argv + TRAIN_ARGV + ["--synthetic-cache", cache,
                                                        "--log-dir", str(tmp_path / "logs")])
    assert built == [False, False, False]
    assert synthetic.render_stn_crops.batches == renders
    assert os.path.exists(os.path.join(log_dir, "Localizer_2.pt"))

    monkeypatch.setattr(synthetic, "cached_synthetic", cached)
    cold = train_localizer.build_datasets(train_localizer.get_parser().parse_args(argv))
    assert synthetic.render_stn_crops.batches == renders + 1
    for got, tool, want in zip(used, warmed, cold):
        assert len(got.items) == len(tool.items) == len(want.items)
        for a, b, c in zip(got.items, tool.items, want.items):
            for u, v, w in zip(a, b, c):
                assert np.asarray(u).dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(u, w)
                np.testing.assert_array_equal(v, w)


# -- against the JAX package's tool -------------------------------------------------------
@pytest.fixture(scope="module")
def warmed_by_both(tmp_path_factory):
    """Each pipeline's cache warmed by the port's tool here and by the JAX
    tool in one subprocess, in directories of their own."""
    tmp = tmp_path_factory.mktemp("warm")
    pipelines = ("pil", "stn")
    calls = [DATA_ARGV + ["--assessor-pipeline", p, "--synthetic-cache", str(tmp / f"jax_{p}")] for p in pipelines]
    script = f"import sys; sys.path.insert(0, 'tools'); import warm_cache\nfor argv in {calls!r}: warm_cache.main(argv)"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    jax_tool = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        for p in pipelines:
            warm_cache.main(DATA_ARGV + ["--assessor-pipeline", p, "--synthetic-cache", str(tmp / f"port_{p}"),
                                         "--device", "cpu"])
        out = jax_tool.communicate(timeout=600)[0]
    finally:
        jax_tool.kill()
    assert jax_tool.returncode == 0, out[-4000:]
    assert out.count("warmed cache in ") == 2
    return {p: (entries(tmp / f"port_{p}"), entries(tmp / f"jax_{p}")) for p in pipelines}


@pytest.mark.parametrize("pipeline", ["pil", "stn"])
def test_port_tool_writes_the_jax_tools_cache(warmed_by_both, pipeline):
    got, want = warmed_by_both[pipeline]
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            if name.startswith("crops") and pipeline == "stn" and i == 0:
                diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
                assert diff.max() <= RENDER_TOL["steps"], name
                assert (diff > 0).mean() <= RENDER_TOL["share"], name
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} col{i}")
