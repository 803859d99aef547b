"""The harness's arithmetic on hand-made inputs."""

import math

import pytest
import torch
from tiny import cells

from benchlib import profile, roofline, runner


def test_rate():
    assert runner.seeds_per_s(24, 4, 2000, 4.0) == 48000.0


def spans(name, durations):
    t, out = 0.0, []
    for d in durations:
        out.append((name, t, t + d))
        t += d + 1.0
    return out


def test_step_percentile_and_span_means():
    run = {"spans": spans("step", [0.001 * i for i in range(1, 101)])
           + spans("sample", [0.5, 0.25]), "steps": 100}
    assert cells.metric_reader("step_ms_p95").read(run) == pytest.approx(95.05)
    assert cells.metric_reader("sample_ms").read(run) == pytest.approx(7.5)
    assert cells.metric_reader("train_ms").read(run) is None


def test_fetched_rows_per_seed():
    reader = cells.metric_reader("fetched_rows_per_seed")
    run = {"counters": {"fetch.miss_nodes": 300.0, "fetch.replaced_nodes": 100.0}, "seeds": 200}
    assert reader.read(run) == 2.0
    assert reader.read({"counters": {}, "seeds": 200}) is None


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert profile.union_length(iv) == 5.0
    assert profile.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert profile.gaps([], 0, 1) == [(0, 1)]


def test_analyse_hand_made_trace():
    ev = [
        {"ph": "X", "name": "bench.window", "cat": "user_annotation", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "name": "bench.sample", "cat": "user_annotation", "ts": 0, "dur": 40, "tid": 1},
        {"ph": "X", "name": "bench.gather_mean", "cat": "user_annotation", "ts": 50, "dur": 5, "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 51, "dur": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 70, "dur": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "name": "k_mean", "cat": "kernel", "ts": 52, "dur": 8, "args": {"correlation": 7}},
        {"ph": "X", "name": "k_other", "cat": "kernel", "ts": 71, "dur": 20, "args": {"correlation": 8}},
        {"ph": "X", "name": "k_late", "cat": "kernel", "ts": 95, "dur": 10, "args": {"correlation": 9}},
    ]
    p = profile.analyse(ev, ["bench.gather_mean"], {"bench.sample"})
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(33e-6)          # 8 + 20 + 5 inside the window
    assert p.dispatcher_s == {"bench.gather_mean": pytest.approx(8e-6)}
    assert p.top_ops[0] == ["k_other", pytest.approx(20e-6)]
    idle = dict(p.idle_by_host)
    assert idle["bench.sample"] == pytest.approx(52e-6)  # the gap 0..52 has its middle in sample
    assert idle["host.other"] == pytest.approx(15e-6)
    assert sum(idle.values()) == pytest.approx(67e-6)


def test_mfu_flops():
    mfu = cells.metric_reader("mfu.sage")
    b, F, H, C = 2, 3, 4, 5
    flops = mfu.step_flops(b, (2, 3), F, H, C)
    rows1 = b * 2 + b
    layer1 = 4 * rows1 * F * H
    layer2 = 4 * b * H * C
    means = b * 2 * 3 * F + b * 2 * F + b * 2 * H
    assert flops == (layer1 + layer2 + means) + (layer1 + 2 * layer2 + b * 2 * H)
    run = {"spans": [("run", 0.0, 2.0)], "steps": 10, "num_pes": 4, "batch": b,
           "config": {"feature_dim": F, "num_classes": C, "model": {"hidden_dim": H}},
           "traffic": {"fanouts": [2, 3]}}
    assert mfu.read(run) == pytest.approx(100 * flops * 40 / 2.0 / 67e12)


def test_roofline_bytes_and_bound():
    a = torch.zeros(10, dtype=torch.int32)
    b = torch.zeros(3, 4, dtype=torch.float32)
    assert roofline.tensor_bytes((a, None, 3), (b,)) == 40 + 48
    assert roofline.bound(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound(0, 67e12) == pytest.approx(1.0)
    ids = torch.zeros(4, 100)
    aug = torch.zeros(4, 1025)
    cand = torch.zeros(4, 50)
    args = [ids, None, None, None, None, None, aug, None, cand]
    assert roofline.frontier_ops(args) == int(4 * (1024 * (math.log2(1024) + 10) + 10 * 150))


def test_roofline_readers_share():
    reader = cells.metric_reader("segment_sum_equal_roofline")
    x = torch.zeros(30, 8)
    out = torch.zeros(10, 8)
    nbytes, nops = reader.cost((x, 3), {}, out)
    assert nbytes == (240 + 80) * 4 and nops == 240 + 80
    prof = profile.Profile(window_s=1.0, busy_s=0.5,
                           dispatcher_s={"bench.segment_sum_equal": 2e-6})
    run = {"profile": prof, "least_s": {"bench.segment_sum_equal": 1e-6}}
    assert reader.read(run) == pytest.approx(50.0)
    gm = cells.metric_reader("gather_mean_roofline")
    table = torch.zeros(100, 8)
    idx = torch.tensor([[1, 2, 2], [3, 1, 1]])
    later = gm.cost((table, idx), {}, torch.zeros(2, 8))
    assert later() == (3 * 32 + 2 * 32 + 6 * 8, 2 * 3 * 8 + 2 * 8)
    assert cells.metric_reader("idle_pct").read({"profile": prof}) == 50.0


def test_frontier_bytes_count_what_the_launch_needs():
    reader = cells.metric_reader("fused_frontier_step_roofline")
    P, C, K, F = 2, 5, 3, 4
    i32, b = torch.int32, torch.bool
    aug = torch.tensor([[1, 2, 2, 5, -1, 3, 9, 0], [4, 4, 4, 4, 4, 4, 4, 0]], dtype=i32)
    args = [torch.zeros(P, C, dtype=i32), torch.zeros(P, C), torch.zeros(P, C, dtype=b),
            torch.zeros(P, C, dtype=b), torch.zeros(P, C, dtype=b), None, aug,
            torch.zeros(100, dtype=i32), torch.zeros(P, K, dtype=i32), None,
            torch.zeros(P * C, F), torch.zeros(50, F), torch.zeros(50, dtype=torch.int64)]
    counters = torch.tensor([[0, 0, 2, 0], [0, 0, 1, 0]], dtype=i32)
    out = [torch.zeros(P, C, dtype=i32), torch.zeros(P, C), torch.zeros(P, C, dtype=b),
           torch.zeros(P, C, dtype=b), None, None, torch.zeros(P, K, dtype=i32),
           torch.zeros(P, 20, dtype=i32), counters]
    state = 40 + 40 + 10 + 10 + 10 + 64 + 24 + (40 + 40 + 10 + 10 + 24 + 160 + 32)
    part_of = 6 * 4                      # six distinct frontier ids
    store = 3 * (2 * F * 4 + 8)          # three admissions: table row, payload row, row map
    assert reader.cost(args, {}, out)() == (state + part_of + store,
                                             roofline.frontier_ops(args))
