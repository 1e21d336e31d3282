"""The port's serving layer (``snickery_tpu_torch.server``) on the CPU: the
tests of tests/test_server.py against the port's server with a
``Synthesiser(device="cpu")``, and the same requests sent to the JAX
package's server and to the port's, which must answer with the same unit
ids, waves equal to f32 rounding and the same JSON keys.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from snickery_tpu.server import SynthHTTPServer as JaxHTTPServer
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu_torch import server as server_mod
from snickery_tpu_torch.server import DynamicBatcher, SynthHTTPServer, warm_up
from snickery_tpu_torch.synth import Synthesiser
from tests.toyvoice import build_toy_voice

WAVE_ATOL = 1e-5          # f32 OLA sums in another order (tests/test_torch_synth.py)


@pytest.fixture(scope="module")
def toy_voice():
    return build_toy_voice(halfphone=False, multiepoch=1)


@pytest.fixture(scope="module")
def toy_synth(toy_voice):
    cfg, db, utts = toy_voice
    return Synthesiser(cfg, db, device="cpu"), utts


def _targets(synth, utts, n):
    return [np.asarray(utts[i % len(utts)].features, np.float32) for i in range(n)]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _serve(synth, cls=SynthHTTPServer, **kw):
    httpd = cls(synth, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _close(httpd):
    httpd.shutdown()
    httpd.server_close()


def test_batcher_coalesces_requests(toy_synth):
    synth, utts = toy_synth
    batcher = DynamicBatcher(synth, max_batch=8)
    feats = _targets(synth, utts, 3)
    futures = [batcher.submit(f) for f in feats]
    batcher.run_pending_once()          # drain synchronously: ONE batch of 3
    assert batcher.stats["batches"] == 1
    assert batcher.stats["max_batch_seen"] == 3
    assert batcher.batch_sizes == {3: 1}
    direct = synth.synth_batch(feats)
    for fut, ref in zip(futures, direct):
        res = fut.result(timeout=0)
        assert np.array_equal(res["unit_ids"], ref["unit_ids"])
        assert np.allclose(res["wave"], ref["wave"])


def test_batcher_splits_greedy_groups(toy_synth):
    synth, utts = toy_synth
    batcher = DynamicBatcher(synth, max_batch=8)
    feats = _targets(synth, utts, 2)
    f_vit = batcher.submit(feats[0], greedy=False)
    f_greedy = batcher.submit(feats[1], greedy=True)
    batcher.run_pending_once()
    assert batcher.stats["batches"] == 2
    assert f_vit.result(timeout=0)["n_units"] > 0
    assert f_greedy.result(timeout=0)["n_units"] > 0


def test_batcher_propagates_errors(toy_synth):
    """A failed step fails its requests, counted in stats; nothing retries."""
    synth, utts = toy_synth
    batcher = DynamicBatcher(synth, max_batch=8)
    bad = np.zeros((4, 3), np.float32)      # wrong feature dim
    fut = batcher.submit(bad)
    batcher.run_pending_once()
    assert batcher.stats["errors"] == 1 and batcher.stats["batches"] == 1
    with pytest.raises(Exception):
        fut.result(timeout=0)


def test_http_server_end_to_end(toy_synth):
    synth, utts = toy_synth
    httpd, base = _serve(synth, max_wait_ms=50.0)
    try:
        health = json.load(urllib.request.urlopen(base + "/health", timeout=30))
        assert health["status"] == "ok"
        info = json.load(urllib.request.urlopen(base + "/info", timeout=30))
        assert info["n_units"] == synth.db.n_units
        assert info["target_dim"] == synth.db.target_dim
        f = _targets(synth, utts, 1)[0]
        out = json.load(_post(base + "/synth", {
            "features_b64": base64.b64encode(f.tobytes()).decode()}))
        wave = np.frombuffer(base64.b64decode(out["wave_b64"]), np.float32)
        assert out["n_samples"] == len(wave) > 0
        assert out["sample_rate"] == synth.db.sample_rate
        ref = synth.synth_batch([f])[0]
        assert np.array_equal(np.asarray(out["unit_ids"]), ref["unit_ids"])
        assert np.allclose(wave, ref["wave"])
        stats = json.load(urllib.request.urlopen(base + "/stats", timeout=30))
        assert stats["requests"] >= 1
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/synth", {"features": [[1, 2]]})
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/nowhere", timeout=30)
        assert exc.value.code == 404
    finally:
        _close(httpd)


def test_http_concurrent_requests_share_steps(toy_synth):
    synth, utts = toy_synth
    httpd, base = _serve(synth, max_wait_ms=200.0)
    feats = _targets(synth, utts, 4)
    results = [None] * len(feats)

    def post(i):
        results[i] = json.load(_post(base + "/synth", {"features": feats[i].tolist()}))

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(feats))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert all(r is not None for r in results)
        direct = synth.synth_batch(feats)
        for r, ref in zip(results, direct):
            assert np.array_equal(np.asarray(r["unit_ids"]), ref["unit_ids"])
        stats = json.load(urllib.request.urlopen(base + "/stats", timeout=30))
        assert stats["batched_requests"] == len(feats)
        assert stats["batches"] < len(feats) and stats["max_batch_seen"] > 1
    finally:
        _close(httpd)


@pytest.fixture(scope="module")
def hp_voice():
    return build_toy_voice(halfphone=True)


@pytest.fixture(scope="module")
def hp_synth(hp_voice):
    cfg, db, utts = hp_voice
    return Synthesiser(cfg, db, device="cpu"), utts


def _hp_request(synth, utt):
    tgt, kept = synth.halfphone_targets_from_features(utt.features, utt.epochs, utt.halfphones)
    segments = [{"name": s.name, "quinphone": list(s.quinphone)} for s in kept]
    return tgt, kept, segments


def test_http_halfphone_requires_segments_fails_fast(hp_synth):
    synth, utts = hp_synth
    httpd, base = _serve(synth)
    try:
        tgt, _, _ = _hp_request(synth, utts[0])
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/synth", {"features": tgt.tolist()})
        assert exc.value.code == 400
        assert "segments" in json.load(exc.value)["error"]
    finally:
        _close(httpd)


def test_http_halfphone_synth_with_segments(hp_synth):
    synth, utts = hp_synth
    httpd, base = _serve(synth)
    try:
        tgt, kept, segments = _hp_request(synth, utts[0])
        out = json.load(_post(base + "/synth", {"features": tgt.tolist(),
                                                "segments": segments}))
        ref = synth.synth_from_features(tgt, target_segments=kept)
        assert np.array_equal(np.asarray(out["unit_ids"]), ref["unit_ids"])
        wave = np.frombuffer(base64.b64decode(out["wave_b64"]), np.float32)
        assert np.allclose(wave, ref["wave"])
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/synth", {"features": tgt.tolist(), "segments": segments[:-1]})
        assert exc.value.code == 400
    finally:
        _close(httpd)


def test_http_epoch_voice_rejects_segments(toy_synth):
    synth, utts = toy_synth
    httpd, base = _serve(synth)
    try:
        f = _targets(synth, utts, 1)[0]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/synth", {"features": f.tolist(), "segments": [{"name": "x"}]})
        assert exc.value.code == 400
    finally:
        _close(httpd)


def test_http_stream_endpoint_matches_streaming_api(toy_synth):
    synth, utts = toy_synth
    httpd, base = _serve(synth)
    try:
        f = _targets(synth, utts, 1)[0]
        resp = _post(base + "/stream", {"features": f.tolist(), "chunk_frames": 48})
        assert resp.headers["X-Sample-Rate"] == str(synth.db.sample_rate)
        assert resp.headers["X-Audio-Format"] == "float32le"
        wave = np.frombuffer(resp.read(), np.float32)       # urllib de-chunks
        chunks = [f[i:i + 48] for i in range(0, len(f), 48)]
        ref = np.concatenate(list(synth.synth_streaming(iter(chunks))))
        assert wave.tobytes() == ref.astype(np.float32).tobytes()
        assert len(wave) > 0
    finally:
        _close(httpd)


def test_http_stream_rejects_halfphone(hp_synth):
    synth, utts = hp_synth
    httpd, base = _serve(synth)
    try:
        tgt, _, _ = _hp_request(synth, utts[0])
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/stream", {"features": tgt.tolist()})
        assert exc.value.code == 400
    finally:
        _close(httpd)


def test_stats_latency_percentiles(toy_synth):
    synth, utts = toy_synth
    httpd, base = _serve(synth, max_wait_ms=5.0)
    try:
        f = _targets(synth, utts, 1)[0]
        for _ in range(3):
            _post(base + "/synth", {"features": f.tolist()}).read()
        stats = json.load(urllib.request.urlopen(base + "/stats", timeout=30))
        assert stats["n_latency_samples"] >= 3
        assert 0 < stats["latency_p50_ms"] <= stats["latency_p95_ms"]
    finally:
        _close(httpd)


# --------------------------------------------- the JAX server vs the port's
@pytest.fixture(scope="module")
def both_epoch(toy_voice):
    cfg, db, utts = toy_voice
    return JaxSynthesiser(cfg, db=db), Synthesiser(cfg, db, device="cpu"), utts


def _ask_both(jax_synth, port_synth, path, payloads, **kw):
    """The same payloads to the JAX server and to the port's, one at a time;
    returns [(jax response, port response)] of (status, headers, body)."""
    out = []
    servers = [_serve(jax_synth, JaxHTTPServer, **kw), _serve(port_synth, **kw)]
    try:
        for p in payloads:
            pair = []
            for _, base in servers:
                try:
                    r = _post(base + path, p)
                    pair.append((r.status, r.headers, r.read()))
                except urllib.error.HTTPError as e:
                    pair.append((e.code, e.headers, e.read()))
            out.append(pair)
        stats = [json.load(urllib.request.urlopen(base + "/stats", timeout=30))
                 for _, base in servers]
        info = [json.load(urllib.request.urlopen(base + "/info", timeout=30))
                for _, base in servers]
    finally:
        for httpd, _ in servers:
            _close(httpd)
    assert stats[0].keys() == stats[1].keys()
    assert info[0] == info[1]
    return out


def _same_synth_response(a, b):
    assert a[0] == b[0] == 200
    ja, jb = json.loads(a[2]), json.loads(b[2])
    assert ja.keys() == jb.keys()
    assert ja["unit_ids"] == jb["unit_ids"]
    assert ja["n_samples"] == jb["n_samples"] and ja["sample_rate"] == jb["sample_rate"]
    wa, wb = (np.frombuffer(base64.b64decode(j["wave_b64"]), np.float32) for j in (ja, jb))
    np.testing.assert_allclose(wb, wa, atol=WAVE_ATOL)
    # total costs differ by the JAX join distances' f32 cancellation (up to
    # ~0.2 on a natural path); tests/test_torch_synth.py bounds them
    assert np.isfinite(jb["total_cost"]) and np.isfinite(ja["total_cost"])


@pytest.mark.parametrize("greedy", [False, True])
def test_synth_answers_match_the_jax_server(both_epoch, greedy):
    js, ts, utts = both_epoch
    payloads = [{"features_b64": base64.b64encode(
        np.asarray(u.features, np.float32).tobytes()).decode(), "greedy": greedy}
        for u in utts[:2]]
    for a, b in _ask_both(js, ts, "/synth", payloads):
        _same_synth_response(a, b)


def test_halfphone_answers_match_the_jax_server(hp_voice):
    cfg, db, utts = hp_voice
    js, ts = JaxSynthesiser(cfg, db=db), Synthesiser(cfg, db, device="cpu")
    payloads = []
    for u in utts[:2]:
        tgt, _, segments = _hp_request(ts, u)
        payloads.append({"features": tgt.tolist(), "segments": segments})
    payloads.append({"features": payloads[0]["features"]})        # no segments: 400
    pairs = _ask_both(js, ts, "/synth", payloads)
    for a, b in pairs[:2]:
        _same_synth_response(a, b)
    (a, _, ea), (b, _, eb) = pairs[2]
    assert a == b == 400 and json.loads(ea) == json.loads(eb)


def test_stream_answers_match_the_jax_server(both_epoch):
    """/stream: the same headers and float32 audio (to f32 rounding) from
    both servers, for epoch-rate chunks of 32 frames."""
    js, ts, utts = both_epoch
    f = np.asarray(utts[1].features, np.float32)
    [(a, b)] = _ask_both(js, ts, "/stream", [{"features": f.tolist(), "chunk_frames": 32}])
    assert a[0] == b[0] == 200
    for h in ("Content-Type", "Transfer-Encoding", "X-Sample-Rate", "X-Audio-Format"):
        assert a[1][h] == b[1][h], h
    wa, wb = np.frombuffer(a[2], np.float32), np.frombuffer(b[2], np.float32)
    assert len(wa) == len(wb) > 0
    np.testing.assert_allclose(wb, wa, atol=WAVE_ATOL)


def test_warm_up_and_main_use_the_device(toy_voice, monkeypatch):
    """``warm_up`` runs one batched step; ``main`` passes ``--device``
    (default cuda) through to ``serve``."""
    cfg, db, _ = toy_voice
    synth = Synthesiser(cfg, db, device="cpu")
    calls = []
    real = synth.synth_batch
    monkeypatch.setattr(synth, "synth_batch", lambda *a, **k: calls.append(a) or real(*a, **k))
    warm_up(synth)
    assert len(calls) == 1 and calls[0][0][0].shape[1] == db.target_dim
    seen = []
    monkeypatch.setattr(server_mod, "serve", lambda *a: seen.append(a))
    assert server_mod.main(["-c", "v.json", "--port", "9"]) == 0
    assert server_mod.main(["-c", "v.json", "--device", "cpu"]) == 0
    assert seen == [("v.json", "0.0.0.0", 9, 32, 20.0, "cuda"),
                    ("v.json", "0.0.0.0", 8300, 32, 20.0, "cpu")]
