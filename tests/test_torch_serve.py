"""The port's HTTP serving endpoint (``ccvpe_torch.serve``) with the cases
of ``tests/test_serve.py``: healthz, predict round-trips on an ephemeral
port (NANO on the CPU, plain matching), micro-batching, the 413/411/408
bounds and the 503 backpressure; the JAX soak test's counterpart is marked
``slow`` as there.  Each socket test keeps its own bound.  ``/predict`` is
also held against the JAX service on the same exported ``.pt`` and image
bytes; ``--quantize int8 --calib_dir`` serves the int8 model (its reader
against the JAX one); the flag that is not ported exits naming its ROADMAP
item."""

import base64
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
from PIL import Image

from ccvpe_torch import api, serve
from ccvpe_torch.models import cvm


def _nano(seed: int):
    """A seeded NANO model of the port on the CPU, plain matching."""
    return api.load_model(preset="NANO", seed=seed, device="cpu", matching_impl="plain")


@pytest.fixture(scope="module")
def server():
    model = _nano(0)
    service = serve.PoseService(model, "NANO")
    srv = serve.build_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", model
    srv.shutdown()


def _b64_png(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    url, model = server
    with urllib.request.urlopen(url + "/healthz") as r:
        info = json.loads(r.read())
    assert info["status"] == "ok"
    assert info["preset"] == "NANO"
    assert info["grd_hw"] == list(model.cfg.grd_hw)


def test_predict_matches_direct_api(server):
    url, model = server
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 255, (*model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*model.cfg.sat_hw, 3), dtype=np.uint8)
    code, got = _post(url, {"grd": _b64_png(grd), "sat": _b64_png(sat),
                            "return_heatmap": True})
    assert code == 200
    want = model.predict(grd, sat, return_heatmap=True)
    assert (got["row"], got["col"]) == (want.row, want.col)
    np.testing.assert_allclose(got["probability"], want.probability,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got["heatmap"]), want.heatmap,
                               rtol=0, atol=1e-7)


def test_predict_fov_and_prior(server):
    url, model = server
    rng = np.random.default_rng(1)
    grd = rng.integers(0, 255, (*model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*model.cfg.sat_hw, 3), dtype=np.uint8)
    code, got = _post(url, {"grd": _b64_png(grd), "sat": _b64_png(sat),
                            "fov": 180.0, "ori_noise": 18.0})
    assert code == 200
    want = model.predict(grd, sat, fov=180.0, ori_noise=18.0)
    assert (got["row"], got["col"]) == (want.row, want.col)


def test_predict_errors(server):
    url, _ = server
    code, got = _post(url, {"grd": "not-base64!!"})
    assert code in (400, 500)
    assert "error" in got
    with urllib.request.urlopen(url + "/healthz") as r:
        assert r.status == 200  # server survived the bad request


def test_micro_batcher_concurrent_requests():
    """PoseService(batch=4) coalesces concurrent requests into one padded
    device batch and each caller gets the same pose as the direct API."""
    import concurrent.futures


    model = _nano(2)
    service = serve.PoseService(model, "NANO", batch=4, max_wait_ms=50.0)
    rng = np.random.default_rng(3)
    pairs = [(rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8),
              rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8))
             for _ in range(6)]

    def call(i):
        grd, sat = pairs[i]
        return service.predict({"grd": _b64_png(grd), "sat": _b64_png(sat)})

    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        got = list(pool.map(call, range(6)))

    for (grd, sat), g in zip(pairs, got):
        want = model.predict(grd, sat)
        assert (g["row"], g["col"]) == (want.row, want.col), (g, want)
        np.testing.assert_allclose(g["probability"], want.probability,
                                   rtol=1e-5)
    service.stop()


def test_micro_batcher_mixed_parameters_batch_per_key():
    """Requests overriding ori_noise/fov batch among themselves (one
    micro-batcher per parameter key) instead of collapsing to the
    single-pair path: under concurrent mixed load each off-default key
    still serves >1 requests per device dispatch (VERDICT r2 item 5)."""
    import concurrent.futures


    model = _nano(4)
    service = serve.PoseService(model, "NANO", batch=4, max_wait_ms=500.0)
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8),
              rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8))
             for _ in range(8)]

    def call(i):
        grd, sat = pairs[i]
        noise = 18.0 if i % 2 else 180.0  # interleave default / override
        return service.predict({"grd": _b64_png(grd), "sat": _b64_png(sat),
                                "ori_noise": noise})

    # warm both compiled shapes so the timed window isn't one compile long
    call(0), call(1)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(call, range(8)))

    for i, g in enumerate(got):
        grd, sat = pairs[i]
        want = model.predict(grd, sat, ori_noise=18.0 if i % 2 else 180.0)
        assert (g["row"], g["col"]) == (want.row, want.col), (i, g, want)

    override = service.batchers[(18.0, 360.0)]
    assert override.items_served > override.dispatches, (
        f"off-default key never coalesced: {override.items_served} items "
        f"in {override.dispatches} dispatches")
    service.stop()


def test_non_finite_parameters_rejected():
    """NaN ori_noise/fov must be rejected, not become a batcher key
    (NaN != NaN would spawn a fresh worker+compile per request)."""
    import pytest

    model = _nano(8)
    service = serve.PoseService(model, "NANO", batch=2, max_wait_ms=5.0)
    rng = np.random.default_rng(8)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="finite"):
        service.predict({"grd": _b64_png(grd), "sat": _b64_png(sat),
                         "ori_noise": float("nan")})
    assert list(service.batchers) == [(180.0, 360.0)]
    service.stop()


def test_micro_batcher_key_cap_falls_back():
    """Beyond max_batcher_keys distinct parameter keys, requests use the
    single-pair path instead of spawning unbounded workers/compiles."""

    model = _nano(6)
    service = serve.PoseService(model, "NANO", batch=4, max_wait_ms=5.0,
                                max_batcher_keys=1)  # default key only
    rng = np.random.default_rng(7)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    got = service.predict({"grd": _b64_png(grd), "sat": _b64_png(sat),
                           "ori_noise": 18.0})
    want = model.predict(grd, sat, ori_noise=18.0)
    assert (got["row"], got["col"]) == (want.row, want.col)
    assert list(service.batchers) == [(180.0, 360.0)]
    service.stop()


def test_metrics_endpoint(server):
    """/metrics reports request counts and latency percentiles."""
    url, model = server
    rng = np.random.default_rng(9)
    grd = rng.integers(0, 255, (*model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*model.cfg.sat_hw, 3), dtype=np.uint8)
    _post(url, {"grd": _b64_png(grd), "sat": _b64_png(sat)})
    _post(url, {"grd": "broken"})  # counted as an error
    with urllib.request.urlopen(url + "/metrics") as r:
        m = json.loads(r.read())
    assert m["requests"] >= 1
    assert m["errors"] >= 1
    assert m["latency_ms"]["p50"] > 0
    assert m["latency_ms"]["p95"] >= m["latency_ms"]["p50"]


def test_micro_batcher_stop_mid_drain():
    """stop() while the worker is draining a partial batch must not kill the
    worker before pending requests complete (review regression: the None
    sentinel used to be consumed as a request item)."""
    import threading
    import time


    model = _nano(5)
    batcher = serve.MicroBatcher(model, batch=4, max_wait_ms=2000.0)
    rng = np.random.default_rng(6)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)

    results = []
    t = threading.Thread(
        target=lambda: results.append(batcher.submit(grd, sat, False)))
    t.start()
    time.sleep(0.3)   # the worker is now mid-drain, waiting for more items
    batcher.stop()    # sentinel lands inside the drain loop
    t.join(timeout=120)
    assert not t.is_alive(), "pending request hung after stop()"
    assert results and 0 <= results[0].row < cvm.NANO.sat_hw[0]


class _SlowModel:
    """Proxy that makes each device dispatch take ``delay`` seconds, so a
    request burst deterministically outruns the worker and fills the
    admission queue."""

    def __init__(self, model, delay: float):
        self._model, self._delay = model, delay

    @property
    def cfg(self):
        return self._model.cfg

    @property
    def device(self):
        return self._model.device

    def predict_batch(self, *a, **kw):
        import time

        time.sleep(self._delay)
        return self._model.predict_batch(*a, **kw)

    def predict(self, *a, **kw):
        import time

        time.sleep(self._delay)
        return self._model.predict(*a, **kw)


def test_backpressure_flood_rejected_with_503():
    """A burst beyond the bounded micro-batch queue gets 503s (not an
    unbounded backlog); served + rejected covers the whole flood and
    /metrics exposes queue depth + rejections (VERDICT r3 #5)."""
    import concurrent.futures


    model = _nano(10)
    rng = np.random.default_rng(11)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    # warm the compile OUTSIDE the timed/flooded window
    model.predict_batch(np.stack([grd] * 2), np.stack([sat] * 2))

    service = serve.PoseService(_SlowModel(model, 0.4), "NANO", batch=2,
                                max_wait_ms=1.0, queue_depth=2)
    srv = serve.build_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    payload = {"grd": _b64_png(grd), "sat": _b64_png(sat)}

    try:
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            codes = [c for c, _ in pool.map(
                lambda _: _post(url, payload), range(16))]
        assert codes.count(200) >= 1, codes
        assert codes.count(503) >= 1, codes
        assert all(c in (200, 503) for c in codes), codes

        with urllib.request.urlopen(url + "/metrics") as r:
            m = json.loads(r.read())
        assert m["rejections"] == codes.count(503)
        assert "queue_depth" in m
        # overloads are rejections, not errors
        assert m["errors"] == 0, m
    finally:
        srv.shutdown()
        service.stop()


def test_giant_body_rejected_with_413_before_read():
    """Bodies over --max_body_mb get 413 from the Content-Length header
    alone — the server allocates nothing for them (VERDICT r4 weak #6), and
    a flood of giant bodies leaves the server serving normal requests."""
    import concurrent.futures


    model = _nano(12)
    service = serve.PoseService(model, "NANO")
    srv = serve.build_server(service, host="127.0.0.1", port=0,
                             max_body_bytes=1 << 20)  # 1 MB cap
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(13)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    ok_payload = {"grd": _b64_png(grd), "sat": _b64_png(sat)}
    giant = json.dumps({"grd": "A" * (2 << 20), "sat": "A"}).encode()

    def post_giant(_):
        req = urllib.request.Request(
            url + "/predict", data=giant,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            assert "max_body_mb" in body.get("error", ""), body
            return e.code

    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            codes = list(pool.map(post_giant, range(8)))
        assert codes == [413] * 8, codes
        # normal requests still served after the flood
        code, body = _post(url, ok_payload)
        assert code == 200, body
        # bad Content-Length is a 411, not a crash
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1])
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "not-a-number")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 411, resp.status
        conn.close()
    finally:
        srv.shutdown()
        service.stop()


def test_backpressure_single_pair_path():
    """batch=1 (no micro-batcher): the in-flight semaphore caps queued
    request threads; excess concurrent requests raise ServiceOverloaded."""
    import concurrent.futures


    model = _nano(12)
    rng = np.random.default_rng(13)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    model.predict(grd, sat)  # warm the compile

    service = serve.PoseService(_SlowModel(model, 0.4), "NANO", batch=1,
                                max_pending=1)
    payload = {"grd": _b64_png(grd), "sat": _b64_png(sat)}

    def call(_):
        try:
            service.predict(payload)
            return 200
        except serve.ServiceOverloaded:
            return 503

    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        codes = list(pool.map(call, range(6)))
    assert codes.count(200) >= 1 and codes.count(503) >= 1, codes
    assert service.metrics()["rejections"] == codes.count(503)


def test_stalled_body_times_out_with_408():
    """A client that sends headers plus a partial body then stalls is cut
    off by --request_timeout: it gets 408 and a hard close (the half-read
    body must not be misparsed as a next request), the handler thread is
    freed (slowloris bound), and normal requests are still served after."""
    import socket
    import time as time_mod


    model = _nano(12)
    service = serve.PoseService(model, "NANO")
    srv = serve.build_server(service, host="127.0.0.1", port=0,
                             request_timeout=1.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=120)
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: 1000\r\n\r\n" + b'{"grd": "')
        t0 = time_mod.monotonic()
        data = b""
        while b"\r\n\r\n" not in data or b"request_timeout" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        elapsed = time_mod.monotonic() - t0
        assert data.split(b"\r\n", 1)[0].endswith(b"408 Request Timeout"), \
            data[:80]
        assert b"request_timeout" in data
        # generous bound: the socket timeout is 1 s, but a core-starved CI
        # host can delay the starved handler thread's scheduling a lot
        assert elapsed < 90, elapsed
        # hard close after the 408: the stream ends
        s.settimeout(10)
        rest = s.recv(65536)
        while rest and len(rest) < (1 << 16):
            more = s.recv(65536)
            if not more:
                break
            rest += more
        s.close()
        # normal request still served afterwards
        rng = np.random.default_rng(13)
        grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
        sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
        url = f"http://127.0.0.1:{port}"
        code, body = _post(url, {"grd": _b64_png(grd), "sat": _b64_png(sat)})
        assert code == 200, body
    finally:
        srv.shutdown()
        service.stop()


def test_negative_content_length_rejected_and_closed():
    """Content-Length: -1 must not reach rfile.read(-1) (which buffers until
    EOF, unbounded — the DoS the body cap exists to stop): it gets 411 and
    the connection closes so body bytes can't parse as a next request."""
    import http.client


    model = _nano(12)
    service = serve.PoseService(model, "NANO")
    srv = serve.build_server(service, host="127.0.0.1", port=0,
                             max_body_bytes=1 << 20)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=60)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        # body bytes that must NOT be parsed as a next request
        conn.send(b'GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n')
        resp = conn.getresponse()
        assert resp.status == 411, resp.status
        resp.read()
        # server closed the connection: reusing it fails cleanly
        assert resp.isclosed()
        conn.close()
    finally:
        srv.shutdown()
        service.stop()


def test_trickle_body_cannot_extend_deadline():
    """--request_timeout is a WHOLE-BODY deadline, not just an idle timeout:
    a client sending one byte every 0.2 s (never idle) still gets cut off
    with 408 once the deadline passes."""
    import socket
    import time as time_mod


    model = _nano(12)
    service = serve.PoseService(model, "NANO")
    srv = serve.build_server(service, host="127.0.0.1", port=0,
                             request_timeout=1.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    stop = threading.Event()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=120)
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: 100000\r\n\r\n")

        def trickle():
            while not stop.is_set():
                try:
                    s.sendall(b"A")
                except OSError:
                    return
                stop.wait(0.2)

        sender = threading.Thread(target=trickle, daemon=True)
        sender.start()
        t0 = time_mod.monotonic()
        data = b""
        while b"\r\n\r\n" not in data or b"request_timeout" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        elapsed = time_mod.monotonic() - t0
        stop.set()
        assert data.split(b"\r\n", 1)[0].endswith(b"408 Request Timeout"), \
            data[:80]
        # deadline ~1 s + at most one extra recv budget + load headroom
        assert elapsed < 90, elapsed
        s.close()
    finally:
        stop.set()
        srv.shutdown()
        service.stop()


@pytest.mark.slow
def test_abuse_soak_mixed_traffic():
    """Composition soak: normal requests, oversized bodies, negative
    Content-Length, trickle senders, and a 503-provoking flood all hit one
    server CONCURRENTLY for ~20 s. The bounds must compose: the server
    stays alive, normal traffic keeps getting 200s (or clean 503s under
    flood), abuse gets its designated status, and nothing surfaces as an
    unexpected 500 or a crash."""
    import concurrent.futures
    import http.client
    import socket
    import time as time_mod


    model = _nano(12)
    service = serve.PoseService(model, "NANO", batch=2, max_wait_ms=5.0)
    srv = serve.build_server(service, host="127.0.0.1", port=0,
                             max_body_bytes=1 << 20, request_timeout=2.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(21)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    ok_payload = {"grd": _b64_png(grd), "sat": _b64_png(sat)}
    model.predict(grd, sat)  # warm the compile outside the soak window
    stop = threading.Event()
    codes: dict = {"normal": [], "giant": [], "negcl": [], "trickle": []}

    def normal_client():
        while not stop.is_set():
            code, _ = _post(url, ok_payload)
            codes["normal"].append(code)

    def giant_client():
        giant = json.dumps({"grd": "A" * (2 << 20), "sat": "A"}).encode()
        while not stop.is_set():
            req = urllib.request.Request(
                url + "/predict", data=giant,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    codes["giant"].append(r.status)
            except urllib.error.HTTPError as e:
                e.read()
                codes["giant"].append(e.code)
            except OSError:
                codes["giant"].append(-1)  # reset under extreme load: rare

    def negcl_client():
        while not stop.is_set():
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                conn.putrequest("POST", "/predict")
                conn.putheader("Content-Length", "-1")
                conn.endheaders()
                resp = conn.getresponse()
                resp.read()
                codes["negcl"].append(resp.status)
                conn.close()
            except OSError:
                codes["negcl"].append(-1)

    def trickle_client():
        while not stop.is_set():
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=60)
                s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                          b"Content-Length: 50000\r\n\r\n")
                data = b""
                while b"\r\n\r\n" not in data:
                    try:
                        s.sendall(b"B")
                    except OSError:
                        break
                    try:
                        s.settimeout(0.25)
                        data += s.recv(65536)
                    except TimeoutError:
                        continue
                    except OSError:
                        break
                    if not data:
                        break
                if b" " in data[:12]:
                    codes["trickle"].append(int(data.split(b" ")[1]))
                s.close()
            except OSError:
                codes["trickle"].append(-1)

    workers = ([normal_client] * 3 + [giant_client] * 2 + [negcl_client]
               + [trickle_client] * 2)
    with concurrent.futures.ThreadPoolExecutor(len(workers)) as pool:
        futs = [pool.submit(w) for w in workers]
        time_mod.sleep(20)
        stop.set()
        for f in futs:
            f.result(timeout=120)

    try:
        # the server survived and still serves
        code, _ = _post(url, ok_payload)
        assert code == 200
        with urllib.request.urlopen(url + "/metrics") as r:
            metrics = json.loads(r.read())
        # every traffic class got its designated handling
        assert codes["normal"], "no normal requests completed"
        assert set(codes["normal"]) <= {200, 503}, set(codes["normal"])
        assert 200 in codes["normal"], "normal traffic starved out entirely"
        assert set(codes["giant"]) <= {413, -1}, set(codes["giant"])
        assert 413 in codes["giant"]
        assert set(codes["negcl"]) <= {411, -1}, set(codes["negcl"])
        assert set(codes["trickle"]) <= {408, -1}, set(codes["trickle"])
        assert metrics["requests"] >= len(codes["normal"])
    finally:
        srv.shutdown()
        service.stop()


@pytest.mark.parametrize("batch", [1, 2])
def test_main_serves_a_mesh_on_the_cpu_switch(batch, monkeypatch, tmp_path):
    """``--mesh data`` on the CPU switch: two CPU replicas of the model
    (``api.CVMModel(mesh=)``); a /predict answer, through the micro-batcher
    at --batch 2, is the one-device ``predict_batch``'s."""
    net = api.load_model(None, preset="NANO", seed=4, device="cpu")
    ckpt = str(tmp_path / "m.pt")
    net.save_torch(ckpt)
    rng = np.random.default_rng(6)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    want = api.load_model(ckpt, preset="NANO", device="cpu",
                          matching_impl="plain").predict_batch(grd[None], sat[None])[0]
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    started = {}

    def build(service, host, port, **kw):
        srv = serve.ThreadingHTTPServer((host, 0), serve.make_handler(service, **kw))
        started["url"] = f"http://127.0.0.1:{srv.server_address[1]}"
        return _OneShot(srv, started, {"grd": _b64_png(grd), "sat": _b64_png(sat)})

    monkeypatch.setattr(serve, "build_server", build)
    serve.main(["--preset", "NANO", "--host", "127.0.0.1", "--checkpoint", ckpt,
                "--matching_impl", "plain", "--mesh", "data", "--batch", str(batch)])
    assert started["health"]["replicas"] == 2
    got = started["predict"]
    assert (got["row"], got["col"]) == (want.row, want.col)
    assert got["probability"] == pytest.approx(want.probability, rel=1e-5)


def test_main_needs_cuda_or_the_cpu_switch(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    monkeypatch.delenv("CCVPE_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CCVPE_PLATFORM=cpu"):
        serve.main(["--preset", "NANO", "--port", "0"])


def test_main_serves_on_the_cpu_switch(monkeypatch, tmp_path):
    """``CCVPE_PLATFORM=cpu python -m ccvpe_torch.serve``: a training
    checkpoint directory's model on the CPU, answering /healthz."""
    from ccvpe_torch.io.checkpoint import CheckpointManager
    from ccvpe_torch.train import loop as TLOOP

    state = TLOOP.create_train_state(cvm.NANO, seed=3, device="cpu", param_dtype="bfloat16")
    CheckpointManager(str(tmp_path / "ck")).save(0, state)
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    started = {}

    def build(service, host, port, **kw):
        srv = serve.ThreadingHTTPServer((host, 0), serve.make_handler(service, **kw))
        started["url"] = f"http://127.0.0.1:{srv.server_address[1]}"
        return _OneShot(srv, started)

    monkeypatch.setattr(serve, "build_server", build)
    serve.main(["--preset", "NANO", "--host", "127.0.0.1", "--checkpoint",
                str(tmp_path / "ck"), "--matching_impl", "plain", "--batch", "2"])
    assert started["health"]["device"] == "cpu"
    assert started["health"]["batch"] == 2


def _write_calibration_dirs(root, rng):
    """The two --calib_dir layouts: flat <stem>_grd/<stem>_sat files (three
    pairs, one grd without its sat) and grd/ + sat/ subdirectories."""
    import os

    flat, sub = root / "flat", root / "sub"
    os.makedirs(flat)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 80, 3), dtype=np.uint8)).save(flat / f"s{i}_grd.png")
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(flat / f"s{i}_sat.png")
    Image.fromarray(rng.integers(0, 255, (40, 80, 3), dtype=np.uint8)).save(flat / "lone_grd.png")
    for d in ("grd", "sat"):
        os.makedirs(sub / d)
    for name in ("a.png", "b.jpg"):
        Image.fromarray(rng.integers(0, 255, (70, 150, 3), dtype=np.uint8)).save(sub / "grd" / name)
        Image.fromarray(rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
                        ).save(sub / "sat" / name)
    return flat, sub


def test_load_calibration_pairs_both_layouts_equal_jax(tmp_path):
    """``--calib_dir``'s reader against ``ccvpe_tpu.serve.load_calibration_pairs``:
    the same pairs, resized to model shapes, equal arrays; a directory
    without pairs raises."""
    from ccvpe_tpu import serve as jserve

    flat, sub = _write_calibration_dirs(tmp_path, np.random.default_rng(14))
    for root, n, want_n in ((flat, 2, 2), (flat, 16, 3), (sub, 16, 2)):
        got = serve.load_calibration_pairs(str(root), cvm.NANO, n=n)
        want = jserve.load_calibration_pairs(str(root), cvm.NANO, n=n)
        assert len(got) == len(want) == 1
        assert got[0][0].shape == (want_n, *cvm.NANO.grd_hw, 3) and got[0][0].dtype == np.uint8
        assert got[0][1].shape == (want_n, *cvm.NANO.sat_hw, 3)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="no calibration pairs"):
        serve.load_calibration_pairs(str(sub / "grd"), cvm.NANO)


def test_main_quantize_int8_on_the_cpu_switch(monkeypatch, tmp_path, capsys):
    """``serve --quantize int8 --calib_dir D`` on the CPU switch (NANO):
    the service holds the int8 model, and its /predict answers equal that
    model's own ``predict_batch``, through the int8 products."""
    from ccvpe_torch.nn import layers as TL
    from ccvpe_torch.nn.quant import quantized_fraction

    flat, _ = _write_calibration_dirs(tmp_path, np.random.default_rng(15))
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    rng = np.random.default_rng(16)
    grd = rng.integers(0, 255, (*cvm.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 255, (*cvm.NANO.sat_hw, 3), dtype=np.uint8)
    started = {}

    def build(service, host, port, **kw):
        srv = serve.ThreadingHTTPServer((host, 0), serve.make_handler(service, **kw))
        started["url"] = f"http://127.0.0.1:{srv.server_address[1]}"
        started["service"] = service
        return _OneShot(srv, started, {"grd": _b64_png(grd), "sat": _b64_png(sat),
                                       "ori_noise": 36.0})

    monkeypatch.setattr(serve, "build_server", build)
    TL.reset_int8_counts()
    serve.main(["--preset", "NANO", "--host", "127.0.0.1", "--matching_impl", "plain",
                "--quantize", "int8", "--calib_dir", str(flat), "--calib_samples", "2"])
    assert "int8 PTQ calibrated on 2 real pairs" in capsys.readouterr().out
    model = started["service"].model
    assert quantized_fraction(model.net) > 0.5
    n_int8 = sum(isinstance(m, TL.QuantConv2d) for m in model.net.modules())
    # calibration runs the float convs; the served forward runs every int8 one
    assert TL.int8_counts() == {"mm": 0, "plain": n_int8}
    want = model.predict_batch(grd[None], sat[None], ori_noise=36.0)[0]
    got = started["predict"]
    assert (got["row"], got["col"]) == (want.row, want.col)
    assert got["probability"] == want.probability
    assert got["orientation_deg"] == want.orientation_deg


class _OneShot:
    """A server whose ``serve_forever`` answers one /healthz (and one
    /predict of ``payload``, if given) and returns."""

    def __init__(self, srv, record, payload=None):
        self._srv, self._record, self._payload = srv, record, payload

    def serve_forever(self):
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        with urllib.request.urlopen(self._record["url"] + "/healthz", timeout=30) as r:
            self._record["health"] = json.loads(r.read())
        if self._payload is not None:
            code, self._record["predict"] = _post(self._record["url"], self._payload)
            assert code == 200, self._record["predict"]
        self._srv.shutdown()
        self._srv.server_close()

    def shutdown(self):
        pass


@pytest.mark.parametrize("kw", [{}, {"ori_noise": 36.0}, {"fov": 180.0, "ori_noise": 0.0},
                                {"raw": True}])
def test_predict_matches_the_jax_service(kw, tmp_path):
    """The same exported ``.pt`` and the same image bytes through the JAX
    service and the port's: the same pixel, probability within 1e-5,
    heading within 0.1 degree (at raw size both resize with PIL)."""
    from ccvpe_tpu import api as japi
    from ccvpe_tpu import serve as jserve
    from tests.torch_data_roots import write_nano_pt

    pt = write_nano_pt(str(tmp_path / "nano.pt"), seed=31)
    ours = serve.PoseService(api.load_model(pt, preset="NANO", device="cpu",
                                            matching_impl="plain"), "NANO")
    theirs = jserve.PoseService(japi.load_model(pt, preset="NANO"), "NANO")
    rng = np.random.default_rng(32)
    kw = dict(kw)
    raw = kw.pop("raw", False)
    grd_hw = (96, 200) if raw else cvm.NANO.grd_hw
    sat_hw = (150, 150) if raw else cvm.NANO.sat_hw
    for _ in range(3):
        payload = {"grd": _b64_png(rng.integers(0, 255, (*grd_hw, 3), dtype=np.uint8)),
                   "sat": _b64_png(rng.integers(0, 255, (*sat_hw, 3), dtype=np.uint8)),
                   **kw}
        got, want = ours.predict(payload), theirs.predict(payload)
        assert (got["row"], got["col"]) == (want["row"], want["col"]), (got, want)
        assert abs(got["probability"] - want["probability"]) <= 1e-5
        d = abs((got["orientation_deg"] - want["orientation_deg"] + 180) % 360 - 180)
        assert d <= 0.1, (got, want)



def test_launch_counters_hold_under_concurrent_threads():
    """The kernels' launch counters are shared by every batcher's worker:
    each count is one locked update, so none is lost when many threads
    count at once (a short switch interval makes a bare ``+=`` lose some)."""
    import sys

    import torch

    from ccvpe_torch.ops import matching_cuda as MC

    MC.reset_launch_counts()
    threads, per = 32, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            MC._count("matching_scores", "tile", torch.bfloat16) for _ in range(per)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    n = threads * per
    assert MC.launch_counts()["matching_scores"] == n
    assert MC.launch_counts("layout")["matching_scores", "tile"] == n
    assert MC.launch_counts("dtype")["matching_scores", "bfloat16"] == n
    MC.reset_launch_counts()
