"""The port's serving probe on the CPU at 64x128 (its serve phase and its
device-busy arithmetic; the profile phase needs a card)."""

import types

import pytest
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.probe import (
    ConstructorWarmServer,
    _busy_us,
    device_ops_per_step,
    device_time_by_kind,
    serve_run,
    top_device_ops,
)

H, W = 64, 128


@pytest.fixture(scope="module")
def model():
    return FlowModel(FlowModelConfig(), device="cpu", scheme="pwc",
                     generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("warm_up", ["serving", "constructor"])
def test_serve_run_serves_every_request(model, warm_up):
    out = serve_run(model, (H, W), warm_up, n_requests=6, n_clients=3, max_batch=2)
    assert out["warm_up"] == warm_up and out["requests"] == 6
    # the first request runs alone, the 6 others in batches of at most 2
    assert sum(k * n for k, n in enumerate(out["occupancy"])) == 7
    assert out["batches"] == sum(out["occupancy"])
    assert out["pairs_per_s"] > 0 and out["first_request_ms"] > 0
    lat = out["latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"]


def test_constructor_warm_up_runs_on_the_calling_thread(model, monkeypatch):
    import threading

    threads = []
    orig = ConstructorWarmServer._run

    def spy(self, img1, img2):
        threads.append(threading.current_thread())
        return orig(self, img1, img2)

    monkeypatch.setattr(ConstructorWarmServer, "_run", spy)
    srv = ConstructorWarmServer(types.SimpleNamespace(img_hw=(H, W)), model, max_batch=1)
    srv.close()
    assert threads == [threading.current_thread()]


def test_busy_time_is_the_union_of_device_intervals():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(start, end, dev=cuda, name="k"):
        return types.SimpleNamespace(device_type=dev, name=name,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    # [0,10] and [5,12] overlap -> 12; [20,25] -> 5; the CPU event and the
    # host's wait on a full launch queue are not device time
    events = [ev(20, 25), ev(0, 10), ev(5, 12), ev(0, 100, cpu),
              ev(30, 90, name="Command Buffer Full")]
    assert _busy_us(events) == 17


def test_top_device_ops_ranks_device_rows_per_step():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, us, count, dev=cuda):
        return types.SimpleNamespace(key=key, self_device_time_total=us, count=count,
                                     device_type=dev)

    rows = [row("small", 1000, 2), row("aten::conv", 9000, 2, cpu), row("big", 4000, 4),
            row("Command Buffer Full", 50000, 10)]
    assert top_device_ops(rows, steps=2, n=5) == [
        {"op": "big", "ms_per_step": 2.0, "calls_per_step": 2.0},
        {"op": "small", "ms_per_step": 0.5, "calls_per_step": 1.0}]


def test_device_time_by_kind_sums_kernel_rows_per_step():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, us, dev=cuda):
        return types.SimpleNamespace(key=key, self_device_time_total=us, device_type=dev)

    rows = [row("void (anonymous namespace)::corr_df2_kernel<float, 4>", 2000),
            row("sm80_xmma_dgrad_implicit_gemm_f32", 5000), row("aten::convolution", 9000, cpu),
            row("void pointwise_mult_and_sum_complex<float2, 8, 4>", 1000),
            row("void at::native::vectorized_gather_kernel", 1000),
            row("Command Buffer Full", 50000), row("mystery", 400)]
    got = device_time_by_kind(rows, steps=2)
    assert got["port kernels"] == 1.0 and got["convolution (cuDNN/cuBLAS)"] == 3.0
    assert got["gather/scatter (warps)"] == 0.5 and got["other"] == 0.2
    assert sum(got.values()) == 4.7


def test_device_ops_per_step_counts_device_rows():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, count, dev=cuda):
        return types.SimpleNamespace(key=key, count=count, device_type=dev)

    rows = [row("k1", 6), row("k2", 4), row("aten::add", 50, cpu),
            row("Command Buffer Full", 9)]
    assert device_ops_per_step(rows, steps=2) == 5.0
