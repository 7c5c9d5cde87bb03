"""The port's serving probe on the CPU at 64x128 (its serve phase and its
device-busy arithmetic; the profile phase needs a card)."""

import types

import pytest
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.probe import ConstructorWarmServer, _busy_us, serve_run

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

    def ev(start, end, dev=cuda):
        return types.SimpleNamespace(device_type=dev,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    # [0,10] and [5,12] overlap -> 12; [20,25] -> 5; the CPU event is not device time
    events = [ev(20, 25), ev(0, 10), ev(5, 12), ev(0, 100, cpu)]
    assert _busy_us(events) == 17
