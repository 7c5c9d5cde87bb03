"""The port's FlowServer on the CPU (64x128, max_batch 4) and its imports."""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.serve import FlowServer, _Request
from unopticalflow_tpu_torch.utils.device import resolve_device


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 64, 128
RNG = np.random.RandomState(21)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    return FlowModel(FlowModelConfig(), device="cpu", scheme="pwc",
                     generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def engine(model):
    srv = FlowServer(types.SimpleNamespace(img_hw=(H, W)), model,
                     max_batch=4, max_wait_ms=50)
    yield srv
    srv.close()
    assert not srv._thread.is_alive()


def _pair():
    return RNG.rand(2 * H, W, 3).astype(np.float32)


def test_single_request_matches_inference_flow(engine, model):
    pair = _pair()
    flow = engine.infer(pair)
    assert flow.shape == (H, W, 2) and flow.dtype == np.float32
    assert np.isfinite(flow).all()
    with torch.inference_mode():
        want = inference_flow(model, torch.from_numpy(pair[None, :H]),
                              torch.from_numpy(pair[None, H:]))[0].numpy()
    np.testing.assert_allclose(flow, want, rtol=1e-5, atol=1e-5)


def test_concurrent_requests_share_batches(engine):
    pairs = [_pair() for _ in range(4)]
    results = [None] * 4

    def worker(i):
        results[i] = engine.infer(pairs[i])

    before = engine.stats["batches"]
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(r is not None and r.shape == (H, W, 2) for r in results)
    assert engine.stats["batches"] - before <= 3
    assert sum(engine.stats["occupancy"][2:]) >= 1
    # padding rows must not leak: the same pair solo == batched
    np.testing.assert_allclose(engine.infer(pairs[0]), results[0], rtol=1e-5, atol=1e-5)


def test_expired_requests_are_shed(engine):
    expired = _Request(np.zeros((2 * H, W, 3), np.float32), time.perf_counter() - 1.0)
    before = engine.stats["shed"]
    engine.queue.put(expired)
    assert engine.infer(_pair()).shape == (H, W, 2)
    assert expired.event.is_set()
    assert isinstance(expired.error, TimeoutError)
    assert engine.stats["shed"] == before + 1


def test_png_round_trip_over_http(engine):
    import cv2
    from http.server import ThreadingHTTPServer

    from unopticalflow_tpu_torch.serve import make_handler

    cfg = types.SimpleNamespace(img_hw=(H, W))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, cfg))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["img_hw"] == [H, W] and health["max_batch"] == 4
        ok, png = cv2.imencode(".png", RNG.randint(0, 255, (2 * H, W, 3), np.uint8))
        assert ok
        req = urllib.request.Request(f"http://127.0.0.1:{port}/flow",
                                     data=png.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
        assert np.frombuffer(body[:4], np.float32)[0] == np.float32(202021.25)
        assert tuple(np.frombuffer(body[4:12], np.int32)) == (W, H)
        flow = np.frombuffer(body[12:], np.float32).reshape(H, W, 2)
        assert np.isfinite(flow).all()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            assert json.loads(r.read())["served"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_warm_up_failure_raises(model):
    # 60 is not a multiple of 64: the decoder's levels no longer line up
    with pytest.raises(RuntimeError, match="warm-up failed"):
        FlowServer(types.SimpleNamespace(img_hw=(60, W)), model, max_batch=1)


def test_port_imports_leave_jax_out():
    code = (
        "import sys, unopticalflow_tpu_torch, unopticalflow_tpu_torch.serve\n"
        "import unopticalflow_tpu_torch.utils.checkpoint, unopticalflow_tpu_torch.utils.convert\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "unopticalflow_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
