"""Flow inference server of the port: dynamic batching over the CUDA cards.

Same behaviour and HTTP API as the JAX package's root ``serve.py``:

* one fixed ``(max_batch, H, W)`` padded batch, so every dispatch has the
  same shapes, and one warm-up at start-up;
* a collector thread drains the queue up to ``max_batch`` requests or
  ``max_wait_ms``, whichever comes first;
* requests whose waiter has timed out are shed;
* ``served`` / ``batches`` / ``shed`` / ``errors`` / ``occupancy`` stats;
* with more than one card (``data_devices``, default every visible card
  when the model is on CUDA), each batch is split over them as the JAX
  server shards it over its data mesh: the batch is padded up to a multiple
  of the card count, each card runs its contiguous block through
  ``inference_flow`` on its own model replica and stream, and the blocks
  are concatenated in order;
* ``spatial=N`` splits each batch's rows over N devices (``--spatial N``,
  ``parallel/spatial.py``): for frames too large for one card.  The batch
  stays whole, H must be divisible by N * 64 (checked at construction), and
  the flow rows are gathered before they go to the waiters.

The HTTP layer (``make_handler``: ``GET /healthz``, ``GET /stats``, ``POST
/flow`` with an image of the vertically stacked pair, answered with
Middlebury ``.flo`` bytes) is the port's copy of the root ``serve.py``'s; it
decodes PNG (every bit depth and colour type, ``tRNS``, an Exif
orientation, an APNG's first frame), JPEG, BMP, PNM/PAM/PFM, Sun raster,
Radiance HDR, TIFF, WebP, JPEG 2000 (JP2 and J2K) and GIF bodies with the
port's own readers (``utils/imageio.py``), as ``cv2.imdecode`` decodes them,
without opencv; a body they refuse (AVIF, a lossless, arithmetic-coded or
truncated JPEG, a corrupt PNG, TIFF, WebP or JPEG 2000), and one cv2 reads
no image from (a corrupt APNG or GIF), gets a 400 that names why.  ``main`` reads the yaml, so ``FlowServer`` itself needs only torch
and numpy.

Usage:
    python -m unopticalflow_tpu_torch.serve -c config/kitti.yaml \
        --pretrained_model model.pth [--port 8000] [--max_batch 8] \
        [--max_wait_ms 5] [--precision bfloat16] [--device cuda] \
        [--spatial N [--spatial_devices cuda:0,cuda:0]]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from unopticalflow_tpu_torch.evaluation.flowlib import encode_flow
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.parallel import gather_rows, make_spatial_infer, spatial_mesh
from unopticalflow_tpu_torch.parallel.spatial import check_height
from unopticalflow_tpu_torch.utils import imageio
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

MAX_BODY_BYTES = 64 * 1024 * 1024  # a request body larger than this is refused (413)


class _Request:
    __slots__ = ("pair", "event", "flow", "error", "deadline")

    def __init__(self, pair, deadline):
        self.pair = pair  # (2H, W, 3) float32
        self.event = threading.Event()
        self.flow = None
        self.error = None
        self.deadline = deadline  # perf_counter time after which nobody waits


class FlowServer:
    """Dynamic-batching inference engine over one model, split over cards."""

    def __init__(self, cfg, model: FlowModel, max_batch: int = 8,
                 max_wait_ms: float = 5.0, spatial: int = 1, devices=None,
                 data_devices=None):
        """``data_devices``: the devices that each take a block of every
        batch (``["cuda:0", "cuda:0"]`` puts two on one card; ``["cpu",
        "cpu"]`` on the CPU); None is every visible card when ``model`` is
        on CUDA, else ``model``'s device.  ``spatial > 1`` splits each
        frame's rows over ``devices`` instead, as the JAX server's spatial
        mode replaces its data mesh."""
        self.h, self.w = cfg.img_hw
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._spatial = None
        self._pad_batch = max_batch
        self._replicas = []  # (model, device, stream) of each block of a batch
        if spatial > 1:
            # height-sharded serving: ``devices`` (default: the first
            # ``spatial`` CUDA devices) hold the row-shards of every batch
            check_height(self.h, spatial)
            self._spatial = make_spatial_infer(
                self.model, spatial_mesh(spatial, devices=devices))
        else:
            if data_devices is None:
                data_devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                                if self.device.type == "cuda" else [self.device])
            data_devices = [torch.device(d) for d in data_devices]
            n = len(data_devices)
            self._pad_batch = -(-max_batch // n) * n
            for i, dev in enumerate(data_devices):
                replica = self.model if i == 0 and dev == self.device else \
                    copy.deepcopy(self.model).to(dev)
                # one device runs on the current stream; with more, each block
                # has a stream of its own, which first waits for the clones
                stream = torch.cuda.Stream(dev) if n > 1 and dev.type == "cuda" else None
                if stream is not None:
                    stream.wait_stream(torch.cuda.current_stream(dev))
                self._replicas.append((replica, dev, stream))
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
            if self._spatial is not None:
                return gather_rows(self._spatial(img1, img2), "cpu").numpy()
            return self._run_split(img1, img2)

    def _run_split(self, img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        """Each replica's contiguous block of the batch on its device and
        stream, all launched before any is read back; the flows in order
        (one device: the whole batch on the current stream)."""
        b = img1.shape[0] // len(self._replicas)
        flows = []
        for j, (model, dev, stream) in enumerate(self._replicas):
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                i1 = torch.from_numpy(img1[j * b:(j + 1) * b]).to(dev)
                i2 = torch.from_numpy(img2[j * b:(j + 1) * b]).to(dev)
                flows.append(inference_flow(model, i1, i2))
        out = []
        for flow, (_, _, stream) in zip(flows, self._replicas):
            # read back on the stream that computed it
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                out.append(flow.cpu().numpy())
        return np.concatenate(out)

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
            z = np.zeros((self._pad_batch, self.h, self.w, 3), np.float32)
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
                img1 = np.zeros((self._pad_batch, self.h, self.w, 3), np.float32)
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


def _decode_pair(body: bytes, img_hw) -> np.ndarray:
    """Image bytes of a vertically stacked pair -> (2H, W, 3) float32.

    Decoded by ``utils/imageio.py`` as ``cv2.imdecode`` decodes it; a body it
    cannot decode (a format it does not read, a truncated file) raises
    ``ValueError`` with the reason, which the handler sends back in a 400.
    """
    arr = imageio.imdecode(body, imageio.IMREAD_COLOR)
    if arr is None:
        raise ValueError("request body is not a decodable image")
    if arr.shape[0] % 2:
        raise ValueError("stacked pair must have even height")
    h, w = img_hw
    half = arr.shape[0] // 2
    frames = [imageio.resize(arr[:half], (w, h)).astype(np.float32) / 255.0,
              imageio.resize(arr[half:], (w, h)).astype(np.float32) / 255.0]
    return np.concatenate(frames, 0)


def make_handler(server: FlowServer, cfg):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps({
                    "ok": True, "img_hw": list(cfg.img_hw), "max_batch": server.max_batch,
                }).encode())
            elif self.path == "/stats":
                self._send(200, json.dumps(server.stats).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if self.path != "/flow":
                self._send(404, b'{"error": "not found"}')
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY_BYTES:
                    self._send(413, json.dumps({
                        "error": f"body {length} bytes exceeds {MAX_BODY_BYTES}"
                    }).encode())
                    return
                pair = _decode_pair(self.rfile.read(length), cfg.img_hw)
            except Exception as e:  # malformed request -> client error
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            try:
                flow = server.infer(pair)
                self._send(200, encode_flow(flow), "application/octet-stream")
            except TimeoutError as e:  # overload -> retryable server error
                self._send(503, json.dumps({"error": str(e)}).encode())
            except Exception as e:  # device/internal fault -> server error
                self._send(500, json.dumps({"error": str(e)}).encode())

    return Handler


def build_server(cfg, args) -> FlowServer:
    from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained

    device = resolve_device(args.device)
    set_float32_precision(device, args.precision)
    model_cfg = FlowModelConfig(compute_dtype=args.precision)
    model = FlowModel(model_cfg, device=device,
                      generator=torch.Generator().manual_seed(0))
    if args.pretrained_model:
        load_pretrained(model, args.pretrained_model)
    devices = args.spatial_devices.split(",") if args.spatial_devices else None
    return FlowServer(cfg, model, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms, spatial=args.spatial, devices=devices)


def main(argv=None):
    p = argparse.ArgumentParser(description="flow inference server (PyTorch/CUDA)")
    p.add_argument("-c", "--config_file", required=True)
    p.add_argument("--pretrained_model", default=None,
                   help="a reference-format .pth or the JAX package's .ckpt")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--spatial", type=int, default=1,
                   help="split each frame's height over this many devices (frames too "
                        "large for one card; H must be divisible by spatial*64)")
    p.add_argument("--spatial_devices", default=None,
                   help="comma-separated devices of the row-shards (default: the first "
                        "--spatial CUDA devices), e.g. cuda:0,cuda:0 for one card")
    args = p.parse_args(argv)

    from unopticalflow_tpu_torch.utils.config import Config, load_yaml_config

    cfg = Config(load_yaml_config(args.config_file))
    server = build_server(cfg, args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server, cfg))
    print(f"serving flow on http://{args.host}:{args.port} "
          f"(device={args.device}, max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms, precision={args.precision}, spatial={args.spatial}, "
          f"cards a batch={max(1, len(server._replicas))})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
