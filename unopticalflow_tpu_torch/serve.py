"""Flow inference server of the port: dynamic batching on one CUDA device.

Same behaviour and HTTP API as the JAX package's root ``serve.py``:

* one fixed ``(max_batch, H, W)`` padded batch, so every dispatch has the
  same shapes, and one warm-up at start-up;
* a collector thread drains the queue up to ``max_batch`` requests or
  ``max_wait_ms``, whichever comes first;
* requests whose waiter has timed out are shed;
* ``served`` / ``batches`` / ``shed`` / ``errors`` / ``occupancy`` stats.

The HTTP layer (``make_handler``, PNG decoding, ``.flo`` encoding) is the
root ``serve.py``'s, imported when the server starts, since it needs
``yaml`` and ``cv2``; ``FlowServer`` itself needs only torch and numpy.

Usage:
    python -m unopticalflow_tpu_torch.serve -c config/kitti.yaml \
        --pretrained_model model.pth [--port 8000] [--max_batch 8] \
        [--max_wait_ms 5] [--precision bfloat16] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.utils.device import resolve_device


class _Request:
    __slots__ = ("pair", "event", "flow", "error", "deadline")

    def __init__(self, pair, deadline):
        self.pair = pair  # (2H, W, 3) float32
        self.event = threading.Event()
        self.flow = None
        self.error = None
        self.deadline = deadline  # perf_counter time after which nobody waits


class FlowServer:
    """Dynamic-batching inference engine over one model on one device."""

    def __init__(self, cfg, model: FlowModel, max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        self.h, self.w = cfg.img_hw
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {"served": 0, "batches": 0, "shed": 0, "errors": 0,
                      "occupancy": [0] * (max_batch + 1)}
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._warmup_error: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._warmup_error is not None:
            self._thread.join(timeout=5)
            raise RuntimeError("flow server warm-up failed") from self._warmup_error

    def _run(self, img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            i1 = torch.from_numpy(img1).to(self.device)
            i2 = torch.from_numpy(img2).to(self.device)
            return inference_flow(self.model, i1, i2).cpu().numpy()

    def _shed_expired(self, req) -> bool:
        """Load shedding: skip requests whose waiter has already timed out."""
        if req.deadline > time.perf_counter():
            return False
        req.error = TimeoutError("shed: queue wait exceeded request timeout")
        req.event.set()
        self.stats["shed"] += 1
        return True

    def _warm_up(self) -> bool:
        """One run at the fixed serving shape, on the thread that serves
        (PyTorch keeps cuDNN/cuBLAS handles per thread; the correlation
        kernel is built and loaded here too)."""
        try:
            z = np.zeros((self.max_batch, self.h, self.w, 3), np.float32)
            self._run(z, z)
        except Exception as e:  # reported by __init__, which re-raises
            self._warmup_error = e
        self._ready.set()
        return self._warmup_error is None

    def _loop(self):
        if not self._warm_up():
            return
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._shed_expired(first):
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if not self._shed_expired(nxt):
                    batch.append(nxt)
            n = len(batch)
            try:
                img1 = np.zeros((self.max_batch, self.h, self.w, 3), np.float32)
                img2 = np.zeros_like(img1)
                for i, r in enumerate(batch):
                    img1[i] = r.pair[: self.h]
                    img2[i] = r.pair[self.h :]
                flows = self._run(img1, img2)
                for i, r in enumerate(batch):
                    r.flow = flows[i]
            except Exception as e:  # surface device errors to every waiter
                for r in batch:
                    r.error = e
            if batch[0].error is None:
                self.stats["served"] += n
                self.stats["occupancy"][n] += 1
            else:
                # a failed batch served nobody; monitoring keyed on served
                # throughput must see the outage
                self.stats["errors"] += n
            self.stats["batches"] += 1
            for r in batch:
                r.event.set()

    def infer(self, pair: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        req = _Request(pair, time.perf_counter() + timeout)
        self.queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise req.error
        return req.flow

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def build_server(cfg, args) -> FlowServer:
    from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained

    device = resolve_device(args.device)
    model_cfg = FlowModelConfig(compute_dtype=args.precision)
    model = FlowModel(model_cfg, device=device,
                      generator=torch.Generator().manual_seed(0))
    if args.pretrained_model:
        load_pretrained(model, args.pretrained_model)
    return FlowServer(cfg, model, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms)


def main(argv=None):
    p = argparse.ArgumentParser(description="flow inference server (PyTorch/CUDA)")
    p.add_argument("-c", "--config_file", required=True)
    p.add_argument("--pretrained_model", default=None,
                   help="reference-format .pth (export_torch_checkpoint writes one)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # the HTTP helpers and the YAML loader live beside the JAX server
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from http.server import ThreadingHTTPServer

    from serve import make_handler
    from unopticalflow_tpu.utils.config import Config, load_yaml_config

    cfg = Config(load_yaml_config(args.config_file))
    server = build_server(cfg, args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server, cfg))
    print(f"serving flow on http://{args.host}:{args.port} "
          f"(device={args.device}, max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms, precision={args.precision})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
