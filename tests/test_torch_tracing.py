"""The port's phase spans (``loans_tpu_torch/utils/tracing.py``) on the
CPU, at a small size (Localizer R-18 32²→8², ResnetAssessor ch 8, batch
4, 2 steps a call; an SSD body over a 16-anchor coder and a one-conv
detector; a served log dir of the same pair):

* with no profiler running, a pooled call of the alternating, supervised
  and SSD bodies, the feed that gives it its chunk, ``localize_batch`` and
  ``localize`` enter no ``torch.profiler.record_function``;
* under ``torch.profiler.profile`` the same calls leave exactly the spans
  of PERF.md's table, nested as it says: each ``loans.train.step`` holding
  one of each of its body's phases, every step inside
  ``loans.train.call``, and ``loans.feed`` outside the call;
* a training CLI run that ends inside its ``--profile`` window still
  writes its trace, with the step spans in it.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from loans_tpu_torch.cli import train_localizer as cli
from loans_tpu_torch.data.device_data import device_chunk_batches
from loans_tpu_torch.data.ssd_device import SSDPooledBody
from loans_tpu_torch.inference import LocalizerInference
from loans_tpu_torch.models import Localizer, ResnetAssessor
from loans_tpu_torch.ops.geometry import Size
from loans_tpu_torch.ops.multibox import MultiboxCoder
from loans_tpu_torch.train import AlternatingConfig, checkpoint, create_train_state, pooled_step
from loans_tpu_torch.train.ssd_steps import create_ssd_train_state
from loans_tpu_torch.train.steps import alternating_step, supervised_step
from loans_tpu_torch.utils import tracing

IMG, CROP, BATCH, K, POOL = 32, 8, 4, 2, 12
STEP = "loans.train.step"
PHASES = {
    "alternating": ["loans.train.localizer.forward", "loans.train.localizer.backward",
                    "loans.train.localizer.update", "loans.train.assessor.forward",
                    "loans.train.assessor.backward", "loans.train.assessor.update"],
    "supervised": ["loans.train.localizer.forward", "loans.train.localizer.backward",
                   "loans.train.localizer.update"],
    "ssd": ["loans.train.targets", "loans.train.forward", "loans.train.backward", "loans.train.update"],
}


def _uint8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _boxes(rng, n, r):
    """(n, r, 4) pixel yxyx boxes inside an IMG² scene."""
    lo = rng.uniform(0, IMG / 2, (n, r, 2))
    return np.concatenate([lo, lo + rng.uniform(4, IMG / 2, (n, r, 2))], -1).astype(np.float32)


class TinyDetector(nn.Module):
    """(N, 16, 16, 3) -> (loc (N, 16, 4), conf (N, 16, 2)): one anchor on
    each cell of a 4x4 map."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 6, 3, padding=1)
        self.pool = nn.AdaptiveAvgPool2d(4)

    def forward(self, images):
        x = self.pool(self.conv(images.permute(0, 3, 1, 2))).flatten(2).transpose(1, 2)
        return x[..., :4], x[..., 4:]


def _coder():
    c = (np.arange(4) + 0.5) / 4
    cy, cx = np.meshgrid(c, c, indexing="ij")
    return MultiboxCoder(np.stack([cy.ravel(), cx.ravel(), np.full(16, 0.3), np.full(16, 0.3)], -1))


def _pair():
    torch.manual_seed(0)
    loc = Localizer(out_size=Size(CROP, CROP), n_layers=18, input_size=Size(IMG, IMG))
    return loc, ResnetAssessor(ch=8, in_size=Size(CROP, CROP))


def _training(kind):
    """(loc_state, ass_state, groups, body) of one kind of pooled call."""
    rng = np.random.default_rng(3)
    if kind == "ssd":
        torch.manual_seed(0)
        groups = {"train": {"scenes": _uint8(rng, POOL, IMG, IMG, 3), "boxes": _boxes(rng, POOL, 2),
                            "valid": np.ones((POOL, 2), bool)}}
        return create_ssd_train_state(TinyDetector()), None, groups, SSDPooledBody(_coder(), 16)
    loc, ass = _pair()
    if kind == "supervised":
        groups = {"train": {"images": _uint8(rng, POOL, IMG, IMG, 3), "boxes": _boxes(rng, POOL, 1)}}
        return create_train_state(loc), None, groups, supervised_step
    groups = {"unlabeled": {"unlabeled": _uint8(rng, POOL, IMG, IMG, 3)},
              "reference": {"real": _uint8(rng, POOL, CROP, CROP, 3),
                            "labels": rng.uniform(size=(POOL, 1)).astype(np.float32)}}
    return create_train_state(loc), create_train_state(ass), groups, alternating_step


def _pooled_call(kind):
    """One chunk from the feed and one pooled call of ``kind``; the
    localizer's (or detector's) state after it."""
    loc_state, ass_state, groups, body = _training(kind)
    chunks = device_chunk_batches(groups, BATCH, K, device="cpu")
    try:
        chunk = next(chunks)
        loc_state, _, metrics = pooled_step(loc_state, ass_state, chunk, torch.Generator().manual_seed(1), K,
                                            AlternatingConfig(image_size=Size(IMG, IMG)), body=body)
    finally:
        chunks.close()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    return loc_state


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("served"))
    loc, ass = _pair()
    checkpoint.save_manifest(log_dir, {
        "localizer": {"model": "Localizer", "kwargs": {"out_size": [CROP, CROP], "n_layers": 18,
                                                       "input_size": [IMG, IMG]}},
        "assessor": {"model": "ResnetAssessor", "kwargs": {"ch": 8}},
        "snapshot_names": ["Localizer", "ResnetAssessor"]})
    checkpoint.save_params(os.path.join(log_dir, "Localizer_1.pt"), loc.state_dict())
    checkpoint.save_params(os.path.join(log_dir, "ResnetAssessor_1.pt"), ass.state_dict())
    inference = LocalizerInference(log_dir, device="cpu", use_assessor=True)
    frames = np.random.default_rng(4).uniform(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    return inference, frames


def _serve(served):
    inference, frames = served
    boxes, _, scores, _ = inference.localize_batch(list(frames))
    assert boxes.shape == (BATCH, 1, 4) and scores.shape == (BATCH,)
    inference.localize(frames[0])


def _spans(prof, tmp_path):
    """The ``loans.`` spans of a profile: (name, index of the parent or
    None), in order of their start; the parent is the shortest ``loans.``
    span around a span."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("loans.")]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    out = []
    for i, e in enumerate(events):
        around = [j for j, p in enumerate(events) if j != i and p["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= p["ts"] + p["dur"] and (p["ts"], -p["dur"]) < (e["ts"], -e["dur"])]
        out.append((e["name"], min(around, key=lambda j: events[j]["dur"]) if around else None))
    return out


def _profiled(fn, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof, tmp_path)


def test_no_profiler_opens_no_range(served, monkeypatch):
    """``torch.profiler.record_function`` is made to raise; torch's own
    ``Optimizer.step`` enters ``torch.autograd.profiler.record_function``,
    the same class bound in another module, which is left alone."""

    def boom(*args, **kwargs):
        raise AssertionError("a span opened a profiler range with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("loans.feed") is tracing.span(STEP)
    for kind in PHASES:
        _pooled_call(kind)
    _serve(served)


@pytest.mark.parametrize("kind", list(PHASES))
def test_pooled_call_spans_nest(kind, tmp_path):
    spans = _profiled(lambda: _pooled_call(kind), tmp_path)
    names = [name for name, _ in spans]
    assert set(names) == {"loans.feed", "loans.train.call", STEP, *PHASES[kind]}
    assert names.count("loans.feed") == names.count("loans.train.call") == 1
    call = names.index("loans.train.call")
    assert spans[names.index("loans.feed")][1] is None and spans[call][1] is None
    steps = [i for i, name in enumerate(names) if name == STEP]
    assert len(steps) == K and all(spans[i][1] == call for i in steps)
    for i in steps:
        assert [name for name, parent in spans if parent == i] == PHASES[kind]
    assert len(spans) == 2 + K * (1 + len(PHASES[kind]))


def test_serving_spans_nest(served, tmp_path):
    spans = _profiled(lambda: _serve(served), tmp_path)
    assert spans == [
        ("loans.serve.batch", None),
        ("loans.serve.stack", 0),
        ("loans.serve.upload", 0),
        ("loans.serve.forward", 0),
        ("loans.serve.download", 0),
        ("loans.serve.gate", 0),
        ("loans.serve.upload", None),
        ("loans.serve.forward", None),
    ]


def test_profile_window_cut_by_the_run_end_writes_its_trace(tmp_path):
    """``--profile 4 100`` in a run of 8 iterations: the window opens after
    the call that reaches iteration 4 and the run ends inside it."""
    log_dir = cli.main(["synthetic:8", "synthetic:8", "synthetic:4", "--batch-size", "4", "--n-layers", "18",
                        "--target-size", str(IMG), str(IMG), "--crop-size", str(CROP), str(CROP),
                        "--steps-per-call", "2", "--iterations", "8", "--log-interval", "4",
                        "--eval-batches", "1", "--profile", "4", "100", "--device", "cpu",
                        "--log-dir", str(tmp_path / "run")])
    assert os.listdir(os.path.join(log_dir, "profile")) == ["trace_4_8.json"]
    with open(os.path.join(log_dir, "profile", "trace_4_8.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names.count(STEP) == 4 and names.count("loans.train.call") == 2
