"""Entry ``http_synth``: the port's ``SynthHTTPServer`` (with its
``DynamicBatcher``) in this process on a free localhost port, and an
open-loop client (``benchmark/client.py``) in a child process sending
``POST /synth`` requests at the mix's Poisson arrivals.

Set-up prepares every request's body (``features_b64``, the voice, the
decode), warms each length bucket the mix reaches at one request and at a
full batch, then three requests through HTTP, hands the bodies to the
client, and has it send a prelude: the mix's first ``PRELUDE_S`` seconds of
arrivals, with other utterances, whose answers are not counted.  The window
runs from ``go`` until the client reports every request due in it answered,
or ``drain_s`` passed after the last due time.
"""

from __future__ import annotations

import base64
import json
import pickle
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

import benchmark
from benchmark import traffic

PRELUDE_S = 3.0


def _body(features: np.ndarray, voice: int, greedy: bool) -> bytes:
    return json.dumps({"features_b64": base64.b64encode(
        np.ascontiguousarray(features, np.float32).tobytes()).decode(),
        "voice": f"voice{voice}" if voice >= 0 else None, "greedy": greedy}).encode()


def _buckets(run) -> list:
    from snickery_tpu_torch.utils import bucket_length
    spec = run.cell.traffic["epochs"]
    cfg = run.cell.config["synth"]
    return sorted({bucket_length(e - 2, tuple(cfg["length_buckets"]))
                   for e in range(spec["min"], spec["max"] + 1)})


def warm(run):
    from snickery_tpu_torch.server import SynthHTTPServer

    tr, serving = run.cell.traffic, run.cell.config["serving"]
    greedy = bool(tr["greedy"])
    multi = run.synth.is_multivoice
    feats = run.pool[0]["features"]
    for b in _buckets(run):
        for n in (1, serving["max_batch"]):
            run.synth.synth_batch([feats[: b + 2]] * n, greedy=greedy,
                                  voices=[0] * n if multi else None)
    httpd = SynthHTTPServer(run.synth, host="127.0.0.1", port=0,
                            max_batch=serving["max_batch"], max_wait_ms=serving["max_wait_ms"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    run.state.update(httpd=httpd, thread=thread)
    port = httpd.server_address[1]

    seconds = run.state["seconds"]
    asks = traffic.arrivals(tr, run.seed, seconds, len(run.voice_rows), run.state.get("rate"))
    longest = max(range(len(asks)), key=lambda i: asks[i].epochs)
    run.sample = traffic.sample(len(asks), longest, tr["sample"], run.seed)
    keep = set(run.sample)
    reqs = [(a.due_s, _body(run.features(a), a.voice if multi else -1, greedy), i in keep)
            for i, a in enumerate(asks)]
    run.asked = asks
    client = subprocess.Popen([sys.executable, str(Path(benchmark.__file__).parent / "client.py")],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    run.state["client"] = client
    _post_warm(port, [reqs[i][1] for i in range(min(3, len(reqs)))])
    # the prelude: the window's first PRELUDE_S seconds of load, its bodies
    # rotated by half the pool, sent in set-up
    other = [replace(a, pool=(a.pool + tr["pool"] // 2) % tr["pool"]) for a in asks
             if a.due_s < PRELUDE_S]
    lead = [(a.due_s, _body(run.features(a), a.voice if multi else -1, greedy), False)
            for a in other]
    pickle.dump({"port": port, "requests": reqs, "prelude": lead, "drain_s": tr["drain_s"]},
                client.stdin, protocol=pickle.HIGHEST_PROTOCOL)
    client.stdin.flush()
    if client.stdout.readline().strip() != b"ready":
        raise RuntimeError("the client did not start")


def _post_warm(port: int, bodies: list):
    import http.client
    for body in bodies:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/synth", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"a warm-up request got HTTP {resp.status}")


def window(run, seconds: float):
    httpd, client = run.state["httpd"], run.state["client"]
    batcher, timer = httpd.batcher, run.synth.timer
    sizes0 = dict(batcher.batch_sizes)
    step0 = (timer.totals.get("synth_step", 0.0), timer.counts.get("synth_step", 0))
    with run.tracer.window():
        t0 = time.perf_counter()
        client.stdin.write(b"go\n")
        client.stdin.flush()
        if client.stdout.readline().strip() != b"done":
            raise RuntimeError("the client ended before its requests did")
        run.wall_s = time.perf_counter() - t0
    results = pickle.load(client.stdout)
    stop(run)
    sizes = {k: v - sizes0.get(k, 0) for k, v in batcher.batch_sizes.items()}
    run.counters["batch_sizes"] = {k: v for k, v in sizes.items() if v}
    run.counters["synth_step_s"] = timer.totals.get("synth_step", 0.0) - step0[0]
    run.counters["synth_step_n"] = timer.counts.get("synth_step", 0) - step0[1]
    run.steps = sum(run.counters["batch_sizes"].values())
    run.latencies_ms = [r["latency_ms"] for r in results]
    run.late_ms = [r["late_ms"] for r in results]
    run.answers = [({"unit_ids": r["unit_ids"], "total_cost": r["total_cost"],
                     "wave": r.get("wave")} if r["status"] == 200 else None) for r in results]
    errors = [r.get("error") or f"HTTP {r['status']}" for r in results if r["status"] != 200]
    if errors:
        run.log(f"window: {len(errors)} requests failed, first: {errors[0]}")


def stop(run):
    """End the client and the server, and wait for both."""
    client, httpd = run.state.pop("client", None), run.state.pop("httpd", None)
    if client is not None:
        try:
            client.stdin.close()
            client.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            client.kill()
            client.wait()
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
        run.state["thread"].join(timeout=30)
