"""Serving layer of the port: a persistent synthesis server with dynamic
batching, on the card by default.

The counterpart of ``snickery_tpu.server`` with the same JSON and
chunked-transfer protocol, byte for byte: one long-lived process loads the
voice onto the device once, then coalesces concurrent requests into batched
device steps (``Synthesiser.synth_batch``), so the batch size adapts to the
load.

- :class:`DynamicBatcher`: a worker thread drains a request queue, groups
  compatible requests (same greedy flag) and runs ONE ``synth_batch`` per
  group.  Requests arriving while a step runs ship in the next one;
  ``max_wait_ms`` bounds what a lone request waits for company.  A failed
  step fails its requests (HTTP 500); nothing is retried, on the CPU or
  anywhere else.
- :class:`SynthHTTPServer`: a stdlib ``ThreadingHTTPServer`` front end:
  ``POST /synth`` (JSON in, JSON with a base64 float32 wave out; halfphone
  voices take a ``segments`` field, see :func:`_parse_segments`),
  ``POST /stream`` (chunked-transfer float32 audio from
  ``Synthesiser.synth_streaming``; epoch-unit voices only), ``GET /health``,
  ``GET /info``, ``GET /stats`` (with request-latency p50 / p95).

The batcher thread and the ``/stream`` handlers share the device; the
kernel library is built and its launch counts kept under a lock
(``ops.cuda_topk``).  :func:`serve` runs one warm-up step before it listens,
so the first request does not pay the kernel build.

Run: ``python -m snickery_tpu_torch.server -c voice.json --port 8300``
(``--device cpu`` for the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from snickery_tpu_torch import utils

logger = utils.logger


class _Request:
    __slots__ = ("features", "voice", "greedy", "segments", "future",
                 "t_enqueue")

    def __init__(self, features, voice, greedy, segments=None):
        self.features = features
        self.voice = voice
        self.greedy = bool(greedy)
        self.segments = segments        # list[_Seg] (halfphone voices)
        self.future = Future()
        self.t_enqueue = time.time()


class _Seg:
    """Duck-typed stand-in for io.labels.HalfphoneSegment: synth_batch
    reads only ``.name`` and ``.quinphone`` from target segments, and the
    HTTP API carries no timing information."""
    __slots__ = ("name", "quinphone")

    def __init__(self, name: str, quinphone):
        self.name = name
        self.quinphone = quinphone


class DynamicBatcher:
    """Coalesce concurrent synthesis requests into batched device steps.

    ``submit`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to the ``synth_from_features``-shaped result dict.  The
    worker drains everything queued (up to ``max_batch``), waiting at most
    ``max_wait_ms`` after the first request for stragglers; requests with
    different ``greedy`` flags run as separate device steps.
    ``batch_sizes`` counts the steps of each batch size (kept beside
    ``stats``, whose keys are those of the JAX server's ``/stats``).
    """

    def __init__(self, synth, max_batch: int = 32, max_wait_ms: float = 20.0,
                 max_queue: int = 256):
        self.synth = synth
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "max_batch_seen": 0, "errors": 0}
        self.batch_sizes: collections.Counter = collections.Counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- client side -------------------------------------------------------
    def submit(self, features: np.ndarray, voice=None,
               greedy: bool = False, segments=None) -> Future:
        req = _Request(np.asarray(features, np.float32), voice, greedy,
                       segments)
        self.q.put_nowait(req)          # raises queue.Full -> caller maps to 503
        return req.future

    # -- worker side -------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="snickery-torch-batcher")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def _collect(self) -> list[_Request]:
        """Block for the first request, then drain stragglers for up to
        max_wait_ms (or until max_batch)."""
        try:
            first = self.q.get(timeout=0.2)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.time() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def run_pending_once(self):
        """Drain and run what is queued right now (test/synchronous hook)."""
        batch = []
        while len(batch) < self.max_batch:
            try:
                batch.append(self.q.get_nowait())
            except queue.Empty:
                break
        if batch:
            self._run_batch(batch)

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: list[_Request]):
        self.stats["requests"] += len(batch)
        for flag in sorted({r.greedy for r in batch}):
            group = [r for r in batch if r.greedy == flag]
            voices = None
            if any(r.voice is not None for r in group):
                voices = [r.voice for r in group]
            segments_list = None
            if any(r.segments is not None for r in group):
                segments_list = [r.segments for r in group]
            try:
                results = self.synth.synth_batch(
                    [r.features for r in group], greedy=flag, voices=voices,
                    segments_list=segments_list)
                for r, res in zip(group, results):
                    r.future.set_result(res)
            except Exception as e:  # noqa: BLE001 — fail the requests, not the server
                self.stats["errors"] += len(group)
                for r in group:
                    r.future.set_exception(e)
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(group)
            self.stats["max_batch_seen"] = max(
                self.stats["max_batch_seen"], len(group))
            self.batch_sizes[len(group)] += 1


def _b64_f32(arr: np.ndarray) -> str:
    return base64.b64encode(np.asarray(arr, np.float32).tobytes()).decode()


def _parse_features(payload: dict, target_dim: int) -> np.ndarray:
    """Accept either nested lists or base64-packed float32 rows."""
    if "features_b64" in payload:
        flat = np.frombuffer(
            base64.b64decode(payload["features_b64"]), np.float32)
        return flat.reshape(-1, target_dim)
    feats = np.asarray(payload["features"], np.float32)
    if feats.ndim != 2 or feats.shape[1] != target_dim:
        raise ValueError(
            f"features must be (T, {target_dim}); got {feats.shape}")
    return feats


def _parse_segments(payload: dict, synth, n_rows: int):
    """Halfphone request validation: fail fast with a 400-mapped error
    instead of letting synth_batch fail mid-step.

    Contract: halfphone voices REQUIRE ``segments`` — a list (one per
    feature row, which must be unit-rate ``(T_units, 3*d)``) of
    ``{"name": "ae_L", "quinphone": [l2, l1, c, r1, r2]}`` — and epoch
    voices reject it.  Unknown names/phones degrade the same way the
    Python API does (vocab misses rank as mismatches)."""
    halfphone = synth.db.target_representation == "halfphone"
    segs_json = payload.get("segments")
    if not halfphone:
        if segs_json is not None:
            raise ValueError(
                "this voice is epoch-mode: 'segments' is only valid for "
                "halfphone voices")
        return None
    if segs_json is None:
        raise ValueError(
            "this voice is halfphone: pass segments=[{name, quinphone}, "
            "...] (one per unit-rate feature row) alongside features")
    if not isinstance(segs_json, list) or len(segs_json) != n_rows:
        raise ValueError(
            f"segments must be a list with one entry per feature row "
            f"({n_rows}); got {len(segs_json) if isinstance(segs_json, list) else type(segs_json).__name__}")
    out = []
    for i, sj in enumerate(segs_json):
        if not isinstance(sj, dict) or "name" not in sj:
            raise ValueError(f"segments[{i}] must be an object with 'name'")
        quin = sj.get("quinphone")
        if quin is None:
            quin = ("", "", "", "", "")
        if not isinstance(quin, (list, tuple)) or len(quin) != 5:
            raise ValueError(
                f"segments[{i}].quinphone must be 5 phone strings")
        out.append(_Seg(str(sj["name"]), tuple(str(q) for q in quin)))
    return out


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])


class _Handler(BaseHTTPRequestHandler):
    # the server instance stores batcher/synth on the HTTPServer object
    def _send(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *a):  # route through the project logger
        logger.debug("http: " + fmt, *a)

    def do_GET(self):
        srv = self.server
        if self.path == "/health":
            self._send(200, {"status": "ok"})
        elif self.path == "/info":
            db = srv.synth.db
            self._send(200, {
                "n_units": int(db.n_units),
                "sample_rate": int(db.sample_rate),
                "target_dim": int(db.target_dim),
                "target_representation": db.target_representation,
                "voices": (list(db.voice_names)
                           if getattr(db, "voice_names", None) else None),
            })
        elif self.path == "/stats":
            stats = dict(srv.batcher.stats)
            with srv.lat_lock:
                lats = sorted(srv.latencies_ms)
            stats["latency_p50_ms"] = _percentile(lats, 0.50)
            stats["latency_p95_ms"] = _percentile(lats, 0.95)
            stats["n_latency_samples"] = len(lats)
            self._send(200, stats)
        else:
            self._send(404, {"error": "unknown path"})

    def do_POST(self):
        srv = self.server
        if self.path == "/stream":
            self._do_stream()
            return
        if self.path != "/synth":
            self._send(404, {"error": "unknown path"})
            return
        t_req = time.time()
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n) or b"{}")
            feats = _parse_features(payload, srv.synth.db.target_dim)
            segments = _parse_segments(payload, srv.synth, len(feats))
        except Exception as e:  # noqa: BLE001 — malformed request
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        try:
            fut = srv.batcher.submit(feats, voice=payload.get("voice"),
                                     greedy=payload.get("greedy", False),
                                     segments=segments)
        except queue.Full:
            self._send(503, {"error": "queue full"})
            return
        try:
            res = fut.result(timeout=srv.request_timeout)
        except Exception as e:  # noqa: BLE001 — synthesis failure
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        srv.record_latency((time.time() - t_req) * 1e3)
        self._send(200, {
            "wave_b64": _b64_f32(res["wave"]),
            "n_samples": int(len(res["wave"])),
            "sample_rate": int(srv.synth.db.sample_rate),
            "unit_ids": np.asarray(res["unit_ids"]).tolist(),
            "total_cost": float(res.get("total_cost", 0.0)),
        })

    def _do_stream(self):
        """``POST /stream``: chunked-transfer streaming synthesis.

        Body: JSON with ``features``/``features_b64`` (the full target
        trajectory), optional ``chunk_frames`` (target rows per device
        step, default 32), ``voice``, ``fixed_frameshift`` (seconds; > 0
        declares fixed-rate DNN-style features, as in
        ``Synthesiser.synth_streaming``).  Response: HTTP chunked transfer
        of raw little-endian float32 audio, one HTTP chunk per decoded
        audio chunk.  Epoch-unit voices only (halfphone requests 400)."""
        srv = self.server
        t_req = time.time()
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n) or b"{}")
            feats = _parse_features(payload, srv.synth.db.target_dim)
            if srv.synth.db.target_representation == "halfphone":
                raise ValueError("streaming synthesis is epoch-mode only")
            chunk_frames = int(payload.get("chunk_frames", 32))
            if chunk_frames < 1:
                raise ValueError("chunk_frames must be >= 1")
            fixed_fs = float(payload.get("fixed_frameshift", 0.0))
        except Exception as e:  # noqa: BLE001 — malformed request
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        chunks = [feats[i:i + chunk_frames]
                  for i in range(0, len(feats), chunk_frames)]
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Sample-Rate", str(int(srv.synth.db.sample_rate)))
        self.send_header("X-Audio-Format", "float32le")
        self.end_headers()

        def write_chunk(data: bytes):
            if data:
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

        try:
            # streaming is stateful per request (running join context), so
            # it bypasses the batcher; the lock serialises concurrent
            # streams' device steps against each other
            with srv.stream_lock:
                for audio in srv.synth.synth_streaming(
                        iter(chunks), voice=payload.get("voice"),
                        fixed_frameshift=fixed_fs):
                    write_chunk(np.asarray(audio, np.float32).tobytes())
            self.wfile.write(b"0\r\n\r\n")
            srv.record_latency((time.time() - t_req) * 1e3)
        except Exception as e:  # noqa: BLE001 — headers already sent: the
            # chunked stream ends without the terminating 0-chunk, which
            # clients see as a truncated/aborted response
            logger.error("stream failed mid-response: %s: %s",
                         type(e).__name__, e)
            self.close_connection = True


class SynthHTTPServer(ThreadingHTTPServer):
    """HTTP front end owning one Synthesiser + its DynamicBatcher.

    The listen backlog holds 128 pending connections (socketserver's
    default of 5 resets clients when tens connect at once)."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, synth, host: str = "127.0.0.1", port: int = 8300,
                 max_batch: int = 32, max_wait_ms: float = 20.0,
                 request_timeout: float = 300.0):
        super().__init__((host, port), _Handler)
        self.synth = synth
        self.request_timeout = float(request_timeout)
        self.latencies_ms: collections.deque = collections.deque(maxlen=2048)
        self.lat_lock = threading.Lock()
        self.stream_lock = threading.Lock()
        self.batcher = DynamicBatcher(
            synth, max_batch=max_batch, max_wait_ms=max_wait_ms).start()

    def record_latency(self, ms: float) -> None:
        with self.lat_lock:
            self.latencies_ms.append(ms)

    def shutdown(self):
        self.batcher.stop()
        super().shutdown()


def warm_up(synth) -> None:
    """One batched step on a dummy utterance, so that the first request
    does not pay the kernel build and the first launch."""
    cfg = synth.cfg
    dummy = np.zeros((min(64, cfg.length_buckets[0]), synth.db.target_dim),
                     np.float32)
    kw = ({"voices": [synth.db.voice_names[0]]}
          if synth.is_multivoice else {})
    if synth.db.target_representation == "halfphone":
        # requests need a ``segments`` field; warm with a real vocab entry
        # so the warm step also runs the linguistic variant
        name0 = synth.db.unit_names[0]
        kw["segments_list"] = [[_Seg(name0, ("", "", "", "", ""))
                                for _ in range(len(dummy))]]
        logger.info("halfphone voice: POST /synth requires a 'segments' "
                    "field; /stream is unavailable (epoch-mode only)")
    synth.synth_batch([dummy], **kw)


def serve(config_path: str, host: str = "0.0.0.0", port: int = 8300,
          max_batch: int = 32, max_wait_ms: float = 20.0, device: str = "cuda"):
    """Load the voice onto ``device``, warm the path, serve forever."""
    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.synth import Synthesiser

    cfg = load_config(config_path)
    synth = Synthesiser(cfg, device=device)
    warm_up(synth)
    httpd = SynthHTTPServer(synth, host=host, port=port,
                            max_batch=max_batch, max_wait_ms=max_wait_ms)
    logger.info("serving %s (%d units) on %s:%d, device %s",
                cfg.voice_name, synth.db.n_units, host, port, device)
    httpd.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8300)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels) or cpu "
                         "(their plain PyTorch twins)")
    args = ap.parse_args(argv)
    serve(args.config, args.host, args.port, args.max_batch, args.max_wait_ms,
          args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
