"""The open-loop HTTP client of the served cells, a process of its own so
that it shares no interpreter lock with the server.

Protocol on its standard streams: it reads one pickled dict (``port``,
``requests``: a list of (due seconds, body bytes, keep the wave), ``drain_s``,
``prelude``: requests of the same form sent first, in set-up), sends the
prelude and waits for its answers, answers ``ready``, waits for a ``go``
line, then sends each request at its due time counted from ``go`` (a new
connection each, from a pool of threads), writes ``done`` once every request
is answered (or given up), and then one pickled list with each request's status,
latency from its due time to the response's last byte (ms), how late it was
sent (ms), unit ids, total cost and, where asked, the wave.  Responses are
parsed once the window has closed.  Requests still
open ``drain_s`` after the last due time count as never answered.

    python benchmark/client.py   (started by entries/http_synth.py)
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import pickle
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _one(port: int, body: bytes, due: float, t0: float, timeout: float) -> dict:
    """Send one request; keep the response's bytes (parsed after the window,
    so that the client spends no time on them while it is timed)."""
    sent = time.monotonic()
    out = {"status": 0, "late_ms": (sent - t0 - due) * 1e3, "latency_ms": float("inf")}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("POST", "/synth", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        done = time.monotonic()
        conn.close()
        out["status"] = resp.status
        if resp.status == 200:
            out["latency_ms"] = (done - t0 - due) * 1e3
            out["body"] = data
    except (OSError, http.client.HTTPException) as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _parse(out: dict, keep: bool) -> dict:
    data = out.pop("body", None)
    if data is not None:
        try:
            res = json.loads(data)
            out["unit_ids"] = np.asarray(res["unit_ids"], np.int64)
            out["total_cost"] = float(res["total_cost"])
            if keep:
                out["wave"] = np.frombuffer(base64.b64decode(res["wave_b64"]), np.float32)
        except (ValueError, KeyError) as e:
            out["status"], out["latency_ms"] = 0, float("inf")
            out["error"] = f"{type(e).__name__}: {e}"
    return out


def _send_all(port: int, reqs: list, drain_s: float, pool) -> list:
    """Send ``reqs`` ((due, body, keep the wave)) at their due times from
    now; the results, unparsed, once every request has been answered or
    ``drain_s`` has passed after the last due time."""
    results = [None] * len(reqs)
    last_due = max(r[0] for r in reqs)
    t0 = time.monotonic()
    futures = []
    for i, (due, body, _) in enumerate(reqs):
        delay = t0 + due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        timeout = max(1.0, last_due + drain_s - due)
        futures.append((i, pool.submit(_one, port, body, due, t0, timeout)))
    deadline = t0 + last_due + drain_s
    for i, f in futures:
        try:
            results[i] = f.result(timeout=max(0.0, deadline - time.monotonic()))
        except Exception as e:  # noqa: BLE001 — not answered in time
            results[i] = {"status": 0, "latency_ms": float("inf"), "late_ms": 0.0,
                          "error": f"{type(e).__name__}"}
    return results


def main() -> int:
    setup = pickle.load(sys.stdin.buffer)
    pool = ThreadPoolExecutor(max_workers=setup.get("threads", 256))
    if setup.get("prelude"):
        # the mix's own load before the window: threads, connections and
        # the server's buffers reach their steady state in set-up
        _send_all(setup["port"], setup["prelude"], setup["drain_s"], pool)
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    if sys.stdin.buffer.readline().strip() != b"go":
        return 1
    results = _send_all(setup["port"], setup["requests"], setup["drain_s"], pool)
    sys.stdout.write("done\n")                 # the window ends here
    sys.stdout.flush()
    results = [_parse(r, keep) for r, (_, _, keep) in zip(results, setup["requests"])]
    pickle.dump(results, sys.stdout.buffer, protocol=pickle.HIGHEST_PROTOCOL)
    sys.stdout.flush()
    # requests still open end with the process, not with their timeouts
    os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())
