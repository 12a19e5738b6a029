"""HTTP pose-estimation service of the port (standard library only, no web
framework; counterpart of ``ccvpe_tpu/serve.py``):

    python -m ccvpe_torch.serve --checkpoint model.pt --preset VIGOR --port 8571
    CCVPE_PLATFORM=cpu python -m ccvpe_torch.serve --preset NANO --matching_impl plain
    python -m ccvpe_torch.serve --preset VIGOR --batch 8 --quantize int8 --calib_dir pairs/

It runs on the CUDA device (through the matching kernels, ``--matching_impl
kernel``) unless ``CCVPE_PLATFORM=cpu``; without CUDA and without that
switch it raises.  ``--checkpoint`` takes a reference-format ``.pt`` or a
training checkpoint directory (``api.load_model``).  ``--mesh data`` serves
from one replica per visible card (``api.CVMModel(mesh=)``): a batch of N
splits over them.

Endpoints:
  GET  /healthz   -> {"status": "ok", "preset": ..., "device": ...}
  GET  /metrics   -> request and error counts, latency p50/p95/max, queue
                     depth and 503 rejections
  POST /predict   -> body JSON:
      {"grd": "<base64 image file>", "sat": "<base64 image file>",
       "ori_noise": 180.0, "fov": 360.0, "return_heatmap": false}
    response: {"row": r, "col": c, "orientation_deg": d, "probability": p,
               "heatmap": [[...]] if requested}

Images are any size (the model resizes them).  With ``--batch N`` a
``MicroBatcher`` per (ori_noise, fov) key coalesces concurrent requests
into batches of N.  Every batcher's worker thread and the single-pair path
run their device work one at a time, behind the service's lock: one model,
one CUDA stream, and the kernels' launch counters are shared, and a
forward at batch N already fills the card, so running two at once would
buy nothing.  Bounds: 413 on a body over ``--max_body_mb`` (from the
header, before reading), 411 on a bad Content-Length, 408 on a body that
does not arrive within ``--request_timeout``, 503 when a batcher's queue
or the single-pair admission is full.

``--quantize int8`` serves the int8 post-training-quantized model
(``api.CVMModel.quantize_int8``), calibrated on ``--calib_dir``'s image
pairs (``load_calibration_pairs``) or, without it, on one synthetic batch.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image

    raw = base64.b64decode(b64)
    with Image.open(io.BytesIO(raw)) as im:
        # a writable array: torch.from_numpy warns on a read-only one
        return np.array(im.convert("RGB"), np.uint8)


class ServiceOverloaded(Exception):
    """Request rejected: the admission queue is full (client sees 503)."""


class MicroBatcher:
    """Coalesce concurrent requests into one fixed-shape device batch.

    Requests queue up, a worker drains up to ``batch`` of them (waiting at
    most ``max_wait_ms`` after the first), replicates the last sample to
    fill the batch (one shape: the kernels' launch plans and cuDNN's
    algorithm choices are made once), runs one ``predict_batch`` while
    holding ``device_lock``, and fans the poses back out.

    Backpressure: the queue is BOUNDED (``queue_depth``, default 4 batches).
    A flood beyond it is rejected immediately with ``ServiceOverloaded``
    (HTTP 503) instead of growing an unbounded backlog of decoded images —
    the client retries against a server that is keeping up.
    """

    def __init__(self, model, batch: int, max_wait_ms: float = 5.0,
                 ori_noise: float = 180.0, fov: float = 360.0,
                 queue_depth: int | None = None,
                 device_lock: threading.Lock | None = None):
        self.model = model
        self.device_lock = device_lock or contextlib.nullcontext()
        self.batch = batch
        self.max_wait_s = max_wait_ms / 1e3
        self.ori_noise = ori_noise
        self.fov = fov
        self.dispatches = 0     # device batches run (observability/tests)
        self.items_served = 0   # requests served across those batches
        self.rejections = 0     # overload rejections (503s)
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=queue_depth if queue_depth else 4 * batch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def submit(self, grd: np.ndarray, sat: np.ndarray,
               return_heatmap: bool):
        """Blocking: returns the Pose for this request.  Raises
        ``ServiceOverloaded`` without blocking when the queue is full."""
        event = threading.Event()
        slot: dict = {}
        try:
            self._queue.put_nowait((grd, sat, return_heatmap, event, slot))
        except queue.Full:
            self.rejections += 1  # GIL-atomic enough for a counter
            raise ServiceOverloaded(
                f"micro-batch queue full ({self._queue.maxsize} pending)")
        event.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["pose"]

    def _worker(self):
        while True:
            first = self._queue.get()
            if first is None:
                return
            items = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:  # stop() mid-drain: serve this batch,
                    self._queue.put(None)  # then let the outer loop exit
                    break
                items.append(item)
            try:
                grd = np.stack([it[0] for it in items]
                               + [items[-1][0]] * (self.batch - len(items)))
                sat = np.stack([it[1] for it in items]
                               + [items[-1][1]] * (self.batch - len(items)))
                want_hm = any(it[2] for it in items)
                with self.device_lock:
                    poses = self.model.predict_batch(
                        grd, sat, ori_noise=self.ori_noise, fov=self.fov,
                        return_heatmap=want_hm)
                self.dispatches += 1
                self.items_served += len(items)
                for (g, s, rh, event, slot), pose in zip(items, poses):
                    if not rh:
                        pose.heatmap = None
                    slot["pose"] = pose
                    event.set()
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                for _, _, _, event, slot in items:
                    slot["error"] = e
                    event.set()

    def stop(self):
        self._queue.put(None)


class PoseService:
    """Model wrapper shared by all request threads; ``lock`` serialises the
    device work of every batcher and of the single-pair path."""

    def __init__(self, model, preset: str, batch: int = 1,
                 max_wait_ms: float = 5.0, max_batcher_keys: int = 8,
                 queue_depth: int | None = None, max_pending: int = 64):
        self.model = model
        self.preset = preset
        self.lock = threading.Lock()
        self.queue_depth = queue_depth
        # single-pair path admission cap: ThreadingHTTPServer spawns a
        # thread per connection, so without a bound a flood parks unbounded
        # threads (each holding decoded images) on self.lock
        self._pending = threading.Semaphore(max_pending)
        self._rejections_direct = 0
        # batch > 1: route /predict traffic through one micro-batcher per
        # (ori_noise, fov) key, created lazily — requests overriding the
        # defaults still batch among themselves instead of collapsing to the
        # single-pair path (each key is its own forward, so batchers cannot
        # be merged).  ``max_batcher_keys`` bounds the number of worker
        # threads a client mix can create; keys beyond the cap use the
        # single-pair path.
        self.batch = batch
        self.max_wait_ms = max_wait_ms
        self.max_batcher_keys = max_batcher_keys
        self.batchers: dict[tuple[float, float], MicroBatcher] | None = (
            {} if batch > 1 else None)
        self._batchers_lock = threading.Lock()
        if self.batchers is not None:  # default key, eagerly
            self._get_batcher(180.0, 360.0)
        self._stats_lock = threading.Lock()
        self._latencies_ms: list[float] = []  # bounded success window
        self._requests = 0  # cumulative, errors included
        self._errors = 0    # cumulative

    def _get_batcher(self, ori_noise: float, fov: float):
        """The micro-batcher for this parameter key, lazily created; None
        when batching is off or the key cap is reached."""
        if self.batchers is None:
            return None
        key = (ori_noise, fov)
        with self._batchers_lock:
            b = self.batchers.get(key)
            if b is None:
                if len(self.batchers) >= self.max_batcher_keys:
                    return None
                b = MicroBatcher(self.model, self.batch, self.max_wait_ms,
                                 ori_noise=ori_noise, fov=fov,
                                 queue_depth=self.queue_depth,
                                 device_lock=self.lock)
                self.batchers[key] = b
            return b

    def stop(self):
        if self.batchers is not None:
            with self._batchers_lock:
                for b in self.batchers.values():
                    b.stop()

    def _record(self, t0: float):
        with self._stats_lock:
            self._latencies_ms.append((time.monotonic() - t0) * 1e3)
            if len(self._latencies_ms) > 10000:  # bounded window
                del self._latencies_ms[:5000]

    def metrics(self) -> dict:
        """Cumulative request/error counts plus p50/p95/max latency (ms)
        over the last <=10k successful requests."""
        with self._stats_lock:
            lat = list(self._latencies_ms)
            requests, errors = self._requests, self._errors
        out = {"requests": requests, "errors": errors,
               "latency_window": len(lat)}
        # overload observability: live queue depth + cumulative 503s
        depth, rejections = 0, self._rejections_direct
        if self.batchers is not None:
            with self._batchers_lock:
                for b in self.batchers.values():
                    depth += b.queue_depth()
                    rejections += b.rejections
        out["queue_depth"] = depth
        out["rejections"] = rejections
        if lat:
            lat.sort()
            out["latency_ms"] = {
                "p50": round(lat[len(lat) // 2], 3),
                "p95": round(lat[min(len(lat) - 1,
                                     int(len(lat) * 0.95))], 3),
                "max": round(lat[-1], 3),
            }
        return out

    def info(self) -> dict:
        with self._batchers_lock:  # racing lazy creation in _get_batcher
            keys = sorted(self.batchers) if self.batchers is not None else []
        return {"status": "ok", "preset": self.preset,
                "device": str(self.model.device),
                "replicas": len(self.model.replicas),
                "batch": self.batch if self.batchers is not None else 1,
                "batcher_keys": keys,
                "grd_hw": list(self.model.cfg.grd_hw),
                "sat_hw": list(self.model.cfg.sat_hw)}

    def predict(self, payload: dict) -> dict:
        t0 = time.monotonic()
        with self._stats_lock:
            self._requests += 1
        try:
            out = self._predict(payload)
        except ServiceOverloaded:
            raise  # counted in rejections, not errors
        except Exception:
            with self._stats_lock:
                self._errors += 1
            raise
        self._record(t0)
        return out

    def _predict(self, payload: dict) -> dict:
        grd = _decode_image(payload["grd"])
        sat = _decode_image(payload["sat"])
        ori_noise = float(payload.get("ori_noise", 180.0))
        fov = float(payload.get("fov", 360.0))
        # NaN would defeat the batcher-key dict (NaN != NaN -> one fresh
        # worker thread per request until the key cap)
        if not (math.isfinite(ori_noise) and math.isfinite(fov)):
            raise ValueError(
                f"ori_noise/fov must be finite, got {ori_noise}/{fov}")
        return_heatmap = bool(payload.get("return_heatmap", False))
        batcher = self._get_batcher(ori_noise, fov)
        if batcher is not None:
            cfg = self.model.cfg
            from .api import _prepare

            pose = batcher.submit(_prepare(grd, cfg.grd_hw),
                                  _prepare(sat, cfg.sat_hw),
                                  return_heatmap)
        else:
            if not self._pending.acquire(blocking=False):
                self._rejections_direct += 1
                raise ServiceOverloaded(
                    "too many in-flight single-pair requests")
            try:
                with self.lock:  # one forward on the device at a time
                    pose = self.model.predict(grd, sat, ori_noise=ori_noise,
                                              fov=fov,
                                              return_heatmap=return_heatmap)
            finally:
                self._pending.release()
        out = {"row": pose.row, "col": pose.col,
               "orientation_deg": (None if math.isnan(pose.orientation_deg)
                                   else pose.orientation_deg),
               "probability": pose.probability}
        if return_heatmap:
            out["heatmap"] = np.asarray(pose.heatmap).tolist()
        return out


def load_calibration_pairs(calib_dir: str, cfg, n: int = 16):
    """Real-sample int8 calibration set from a directory of image pairs.

    Accepts either ``<stem>_grd.<ext>`` + ``<stem>_sat.<ext>`` flat files or
    ``grd/`` + ``sat/`` subdirectories with matching filenames.  Images are
    resized to the model's input shapes; returns the one-batch ``calib``
    list ``api.CVMModel.quantize_int8`` takes.
    """
    import os

    from PIL import Image

    from .api import _prepare

    def read(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    pairs = []
    gdir, sdir = (os.path.join(calib_dir, d) for d in ("grd", "sat"))
    if os.path.isdir(gdir) and os.path.isdir(sdir):
        for name in sorted(os.listdir(gdir)):
            spath = os.path.join(sdir, name)
            if os.path.exists(spath):
                pairs.append((os.path.join(gdir, name), spath))
    else:
        stems: dict[str, dict] = {}
        for name in sorted(os.listdir(calib_dir)):
            stem, ext = os.path.splitext(name)
            for kind in ("grd", "sat"):
                if stem.endswith(f"_{kind}"):
                    stems.setdefault(stem[:-4], {})[kind] = os.path.join(
                        calib_dir, name)
        pairs = [(v["grd"], v["sat"]) for v in stems.values()
                 if len(v) == 2]
    if not pairs:
        raise FileNotFoundError(
            f"no calibration pairs in {calib_dir} (expected grd/+sat/ "
            f"subdirs or <stem>_grd.<ext>/<stem>_sat.<ext> files)")
    pairs = pairs[:n]
    grd = np.stack([_prepare(read(g), cfg.grd_hw) for g, _ in pairs])
    sat = np.stack([_prepare(read(s), cfg.sat_hw) for _, s in pairs])
    return [(grd, sat)]


def make_handler(service: PoseService, max_body_bytes: int = 64 << 20,
                 request_timeout: float = 60.0):
    """``max_body_bytes`` bounds per-request allocation: oversized uploads
    are rejected with 413 from the Content-Length header, BEFORE any body
    bytes are read or decoded — the admission semaphore and bounded batcher
    queue bound *concurrency*; this bounds memory per connection.

    ``request_timeout`` bounds per-connection *time*: the thread-per-
    connection server otherwise lets a client that stalls mid-body (or
    idles between keep-alive requests) pin a handler thread forever
    (slowloris).  The socket timeout closes idle connections; a stall
    mid-body gets 408 and a hard close (the half-read body could otherwise
    be misparsed as the next pipelined request)."""
    class Handler(BaseHTTPRequestHandler):
        timeout = request_timeout  # BaseHTTPRequestHandler: socket timeout
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, service.info())
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _read_body(self, n: int) -> bytes:
            """Read exactly ``n`` bytes under a WHOLE-BODY deadline.

            The socket timeout alone is per-recv (idle): a trickle client
            sending 1 byte per 59 s would extend a single ``read(n)``
            indefinitely.  Chunked ``read1`` issues at most one recv per
            loop iteration, each with the *remaining* deadline budget, so
            the total read is bounded by ~request_timeout regardless of
            the client's send pattern."""
            deadline = time.monotonic() + request_timeout
            chunks, got = [], 0
            while got < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("body deadline exceeded")
                self.connection.settimeout(remaining)
                chunk = self.rfile.read1(min(n - got, 1 << 16))
                if not chunk:
                    raise OSError("client closed mid-body")
                chunks.append(chunk)
                got += len(chunk)
            self.connection.settimeout(request_timeout)
            return b"".join(chunks)

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n < 0:
                        raise ValueError(n)
                except ValueError:
                    # length unknown/negative: the body can't be skipped or
                    # safely read (read(-1) would buffer until EOF,
                    # unbounded), so close instead of keep-alive — leftover
                    # body bytes must not parse as the next request
                    self.close_connection = True
                    self._send(411, {"error": "bad Content-Length"})
                    return
                if n > max_body_bytes:
                    # body never buffered: reply 413 from the header alone,
                    # then drain a bounded amount in fixed-size discarded
                    # chunks (lingering close) so a client still sending
                    # reads the 413 instead of a connection reset; close the
                    # connection so unread bytes can't be misparsed as a
                    # request.  The drain is bounded in bytes AND time.
                    self.close_connection = True
                    self._send(413, {
                        "error": f"request body {n} bytes exceeds the "
                                 f"{max_body_bytes}-byte limit "
                                 f"(--max_body_mb)"})
                    try:
                        self.wfile.flush()
                        deadline = time.monotonic() + request_timeout
                        left = min(n, 4 * max_body_bytes)
                        while left > 0:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            self.connection.settimeout(remaining)
                            chunk = self.rfile.read1(min(left, 1 << 16))
                            if not chunk:
                                break
                            left -= len(chunk)
                    except OSError:
                        pass  # client already gone
                    return
                try:
                    raw = self._read_body(n)
                except (TimeoutError, OSError):
                    self.close_connection = True
                    self._send(408, {"error": "timed out reading request "
                                              "body (--request_timeout)"})
                    return
                payload = json.loads(raw)
                self._send(200, service.predict(payload))
            except KeyError as e:
                self._send(400, {"error": f"missing field {e}"})
            except ServiceOverloaded as e:
                self._send(503, {"error": str(e), "retry": True})
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def build_server(service: PoseService, host: str = "127.0.0.1",
                 port: int = 8571,
                 max_body_bytes: int = 64 << 20,
                 request_timeout: float = 60.0) -> ThreadingHTTPServer:
    return ThreadingHTTPServer(
        (host, port),
        make_handler(service, max_body_bytes, request_timeout))


def serve_mesh(mesh: str, device):
    """``--mesh data``: every visible CUDA device; on the CPU
    (``CCVPE_PLATFORM=cpu``) two CPU replicas, so the split path runs."""
    if not mesh:
        return None
    return "data" if device.type == "cuda" else [device, device]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None,
                    help="reference-format .pt or a training checkpoint directory "
                         "(default: seeded random weights)")
    ap.add_argument("--preset", default="VIGOR")
    ap.add_argument("--matching_impl", default="kernel", choices=["kernel", "plain"],
                    help="orientation matching: the CUDA kernels (on a CUDA device) or "
                         "their plain PyTorch versions")
    ap.add_argument("--mesh", default="", choices=["", "data"],
                    help="'data': one model replica per visible CUDA device; batched "
                         "inference splits over them (pairs well with --batch N "
                         "for full mesh batches)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--batch", type=int, default=1,
                    help=">1: micro-batch concurrent requests into one "
                         "fixed-shape device batch")
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="micro-batcher: max wait after the first queued "
                         "request before dispatching a short batch")
    ap.add_argument("--warmup", action="store_true",
                    help="run the default forward once (builds the kernels) "
                         "before serving")
    ap.add_argument("--quantize", default="", choices=["", "int8"],
                    help="post-training quantization of the serving model "
                         "(int8: int8 conv products with int32 sums, nn/quant.py); "
                         "pass --calib_dir for deployment-grade activation "
                         "scales — without it calibration uses ONE "
                         "synthetic uniform-noise batch and real-image "
                         "pose accuracy can degrade")
    ap.add_argument("--calib_dir", default="",
                    help="directory of real image pairs for int8 activation "
                         "calibration: <stem>_grd.<ext> + <stem>_sat.<ext> "
                         "files, or grd/ and sat/ subdirectories with "
                         "matching names")
    ap.add_argument("--calib_samples", type=int, default=16,
                    help="max pairs read from --calib_dir")
    ap.add_argument("--queue_depth", type=int, default=0,
                    help="micro-batcher admission queue bound (default "
                         "4x batch); beyond it requests get 503")
    ap.add_argument("--max_body_mb", type=int, default=64,
                    help="reject request bodies over this size with 413 "
                         "before reading them (bounds per-connection "
                         "memory)")
    ap.add_argument("--request_timeout", type=float, default=60.0,
                    help="per-connection time bound in seconds: both the "
                         "idle socket timeout and the whole-request-body "
                         "read deadline (a trickle sender cannot extend "
                         "it); idle connections close, a body stall gets "
                         "408 (bounds per-connection time)")
    args = ap.parse_args(argv)

    from . import api
    from .utils.platform import env_device

    device = env_device()
    model = api.load_model(args.checkpoint, preset=args.preset, device=device,
                           matching_impl=args.matching_impl,
                           mesh=serve_mesh(args.mesh, device))
    if args.quantize == "int8":
        if args.calib_dir:
            calib = load_calibration_pairs(args.calib_dir, model.cfg,
                                           args.calib_samples)
            model.quantize_int8(calib)
            print(f"model quantized: int8 PTQ calibrated on "
                  f"{int(calib[0][0].shape[0])} real pairs "
                  f"from {args.calib_dir}")
        else:
            model.quantize_int8()
            print("WARNING: int8 PTQ calibrated on ONE synthetic "
                  "uniform-noise batch; real-image activation ranges can "
                  "differ materially and pose accuracy may degrade — pass "
                  "--calib_dir with real samples before production use")
    service = PoseService(model, args.preset, batch=args.batch,
                          max_wait_ms=args.max_wait_ms,
                          queue_depth=args.queue_depth or None)
    if args.warmup:
        cfg = model.cfg
        rng = np.random.default_rng(0)
        model.predict(rng.integers(0, 255, (*cfg.grd_hw, 3), dtype=np.uint8),
                      rng.integers(0, 255, (*cfg.sat_hw, 3), dtype=np.uint8))
        print("warmup forward done")
    server = build_server(service, args.host, args.port,
                          max_body_bytes=args.max_body_mb << 20,
                          request_timeout=args.request_timeout)
    print(f"serving {args.preset} on http://{args.host}:{args.port} "
          f"({model.device}; /healthz, /predict, /metrics)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        service.stop()


if __name__ == "__main__":
    main()
