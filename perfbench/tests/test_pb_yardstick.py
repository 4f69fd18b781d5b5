"""The frozen arithmetic: the crop's least time on a hand-worked theta, the
percentile, the union of device intervals and the labelled idle gaps on a
made-up trace, the seeded inputs, and the FLOP counts against hand counts."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch

from perfbench import harness, inputs, trace, yardstick
from perfbench.reference import loans_pair as ref


def test_crop_bound_hand_worked():
    theta = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])  # identity: out 2x2 samples pixels 0 and 3
    ms, which = yardstick.crop_bound_ms("fwd", (1, 4, 4, 1), theta, (2, 2))
    # region: rows {0, 3} x columns {0, 3}, 16 bytes; crop 16; theta 24
    assert which == "bytes" and ms == pytest.approx(56 / 3.35e12 * 1e3, rel=1e-12)
    ms, which = yardstick.crop_bound_ms("bwd_theta", (1, 4, 4, 1), theta, (2, 2))
    # the hat's derivative is non-zero at |d| = 1 too: rows and columns {0, 1, 2, 3}
    assert which == "bytes" and ms == pytest.approx((64 + 16 + 48) / 3.35e12 * 1e3, rel=1e-12)
    ms, _ = yardstick.crop_bound_ms("bwd_images", (1, 4, 4, 1), theta, (2, 2))
    assert ms == pytest.approx((16 + 64 + 24) / 3.35e12 * 1e3, rel=1e-12)


def test_frozen_taps_equal_the_programs():
    from loans_tpu_torch.ops import stn

    gen = torch.Generator().manual_seed(0)
    scale, shift = 0.5 + torch.rand(5, generator=gen), torch.rand(5, generator=gen) - 0.5
    mine = yardstick._offsets(scale, shift, 75, 224)
    assert torch.equal(mine, stn._offsets(scale, shift, 75, 224))
    assert torch.equal(yardstick._hat(mine), stn._hat(mine))
    assert torch.equal(yardstick._hat_grad(mine), stn._hat_grad(mine))


def test_percentile_is_linear_between_ranks():
    values = list(range(1, 21))
    assert yardstick.percentile(values, 95) == pytest.approx(19.05)
    assert yardstick.percentile(values, 95) == pytest.approx(statistics.quantiles(values, n=20, method="inclusive")[18])
    assert yardstick.percentile([3.0], 95) == 3.0


def test_union_and_gaps():
    intervals = [(10, 30), (20, 40), (50, 60), (55, 58), (90, 120)]
    assert yardstick.merged(intervals, 0, 100) == [(10, 40), (50, 60), (90, 100)]
    assert yardstick.union_length(intervals, 0, 100) == 50
    assert yardstick.gaps(intervals, 0, 100) == [(0, 10), (40, 50), (60, 90)]
    assert yardstick.gaps([], 0, 5) == [(0, 5)]


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_idle_share_and_labels():
    data = {"traceEvents": [
        _event("user_annotation", trace.SPAN, 0, 100),
        _event("gpu_user_annotation", trace.SPAN, 0, 100),  # a range on the device's timeline, no activity
        _event("kernel", "conv_a", 10, 20),
        _event("kernel", "conv_b", 20, 20),  # overlaps conv_a on another stream: counted once
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 10),
        _event("cpu_op", "aten::conv", 0, 60),
        _event("cuda_runtime", "cudaLaunchKernel", 65, 5),
        _event("cpu_op", "aten::copy_", 60, 40),
        _event("cuda_runtime", "cudaMemcpyAsync", 75, 20),
        {"ph": "i", "name": "instant", "ts": 3},
    ]}
    t = trace.Trace.from_chrome(data)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.idle_share() == pytest.approx(0.6)
    assert t.kernels() == 2
    assert t.copy_s("HtoD") == pytest.approx(10e-6) and t.copy_s("DtoH") == 0
    assert t.device_ops()[0][1] == pytest.approx(20e-6) and len(t.device_ops()) == 3
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # (0, 10) and (40, 50) under aten::conv; (60, 100), midpoint 80, inside aten::copy_ and its copy call
    assert gaps == pytest.approx({"aten::conv": 20e-6, "aten::copy_ > cudaMemcpyAsync": 40e-6})
    with pytest.raises(RuntimeError):
        trace.Trace.from_chrome({"traceEvents": data["traceEvents"][2:]})


def test_profile_on_the_cpu_reads_its_span():
    t = trace.profile(lambda: torch.ones(64).sum(), torch.device("cpu"))
    assert t.window_s > 0 and t.busy_s == 0 and t.kernels() == 0


def test_inputs_repeat_for_a_seed():
    big = 2**31 + 12345
    a = inputs.uint8_pool(big, "scenes", (4, 8, 8, 3), "cpu")
    assert torch.equal(a, inputs.uint8_pool(big, "scenes", (4, 8, 8, 3), "cpu"))
    assert not torch.equal(a, inputs.uint8_pool(big + 1, "scenes", (4, 8, 8, 3), "cpu"))
    assert not torch.equal(a, inputs.uint8_pool(big, "crops", (4, 8, 8, 3), "cpu"))
    config = harness.load_json("configs", "loans-r50")
    config["localizer"].update(input_size=[32, 32], out_size=[8, 8])
    spec = ref.weight_spec(config)
    w1, w2 = (inputs.seeded_weights(spec, big, "weights", "cpu") for _ in range(2))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert torch.equal(w1["localizer.param_predictor.bias"], torch.tensor(ref.HEAD_BIAS))


def test_first_epoch_batches_follow_the_programs_feed():
    from loans_tpu_torch.data.device_data import device_chunk_batches

    seed = inputs.index_seed(2**31 + 7)
    groups = {"unlabeled": {"unlabeled": np.zeros((20, 1), np.uint8)},
              "reference": {"real": np.zeros((30, 1), np.uint8), "labels": np.zeros((30, 1), np.float32)}}
    chunks = device_chunk_batches(groups, 4, 3, seed=seed, device="cpu")
    try:
        idx = next(chunks)["idx"]
    finally:
        chunks.close()
    assert np.array_equal(idx["unlabeled"].numpy(), inputs.first_epoch_batches(20, 4, seed, 3))
    assert np.array_equal(idx["reference"].numpy(), inputs.first_epoch_batches(30, 4, seed + 1, 3))


def _conv_macs(k, cin, cout, hw):
    return k * k * cin * cout * hw * hw


def test_flops_against_hand_counts():
    from torch.utils.flop_counter import FlopCounterMode

    config = harness.load_json("configs", "loans-r50")
    loc, ass = ref.build(config, "meta")
    loc.eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        loc.feature_extractor(torch.empty(1, 3, 224, 224, device="meta"))
    # ResNet-50 at 224^2 with the stride on the first 1x1: He et al., table 1, 3.8e9 multiply-adds
    backbone = counter.get_total_flops()
    assert 2 * 3.8e9 < backbone < 2 * 3.9e9
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ass(torch.empty(1, 75, 75, 3, device="meta"))
    hand = (_conv_macs(3, 3, 128, 75) + _conv_macs(4, 128, 128, 37) + _conv_macs(4, 3, 128, 37)
            + _conv_macs(3, 128, 128, 37) + 2 * _conv_macs(4, 128, 128, 18)
            + 4 * _conv_macs(3, 128, 128, 18) + 18 * 18 * 128)
    assert hand == pytest.approx(0.95e9, rel=0.01)
    assert counter.get_total_flops() == 2 * hand
    fl = harness.load_module("flops", "loans-pair")
    serve = fl.count(harness.load_json("workloads", "r50-serve-b32"), config)["serve_batch"]
    train = fl.count(harness.load_json("workloads", "r50-train-b64"), config)["train_step"]
    # a served image: localizer + assessor forward; a step: ~3x the localizer, 2x + 3x the assessor
    assert serve / 32 == pytest.approx(backbone + 2 * hand, rel=0.01)
    assert train / 64 == pytest.approx(3 * backbone + 5 * 2 * hand, rel=0.03)
