"""The port's meshes (``snickery_tpu_torch.parallel``) on the CPU against the
JAX package's (``snickery_tpu.parallel`` on the 8 virtual CPU devices of
tests/conftest.py): each test of tests/test_parallel.py with a counterpart
held to JAX on the same inputs, and the mesh route of the port's
``Synthesiser``, server and CLI.

The port's members are torch devices, repeats allowed: eight members on
"cpu" stand in for the eight virtual devices (the kernel's plain twin runs
on each).  Tolerances:

- unit ids: equal, or (a float32 near-tie sent one side elsewhere) the
  port's path no dearer in float64 than the other side's, within 1e-6 of it,
  and at least 90% of the units the same;
- the port's total costs: rtol 1e-5 (atol 1e-4) of the float64 path cost of
  its own ids (the JAX Viterbi sums joins through the cancelling
  ``|r|^2 + |l|^2 - 2 r.l``, see tests/test_torch_synth.py);
- audio where the ids agree: atol 1e-5 (f32 OLA sums in another order),
  sample totals exact.
"""

import base64
import dataclasses
import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu.parallel import batched_synth_step as jax_step
from snickery_tpu.parallel import make_mesh as jax_make_mesh
from snickery_tpu.parallel import shard_voice as jax_shard_voice
from snickery_tpu.parallel import sharded_norm_stats as jax_norm_stats
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.build import build_voicedb
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch import utils
from snickery_tpu_torch.cli import main as port_cli
from snickery_tpu_torch.io.speech import put_speech
from snickery_tpu_torch.ops.topk import preselect_margin
from snickery_tpu_torch.parallel import (Mesh, batched_synth_step, make_mesh, shard_voice,
                                         sharded, sharded_norm_stats)
from snickery_tpu_torch.parallel.dryrun import dryrun_multichip, synthetic_voice
from snickery_tpu_torch.server import SynthHTTPServer
from snickery_tpu_torch.synth import Synthesiser
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
from tests.test_parallel import _all_to_all_payload_bytes
from tests.toyvoice import build_toy_voice, prepare_toy_utts, toy_config

MESHES = [(8, 1), (4, 2), (2, 4), (2, 2)]
B, T = 8, 256


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the toy shapes gain nothing
    from more, and beside other test workers on the host the extra threads
    only wait on each other (a mesh step issues thousands of small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def voice():
    cfg, db, utts = build_toy_voice(halfphone=False, multiepoch=1)
    return cfg, db, utts, Synthesiser(cfg, db, device="cpu")


@pytest.fixture(scope="module")
def singles(voice):
    """The single-device synth_from_features of each toy utterance."""
    cfg, db, utts, synth = voice
    return [synth.synth_from_features(u.features) for u in utts]


@pytest.fixture(autouse=True)
def _fresh_exchange_counts():
    sharded.EXCHANGE_BYTES.clear()


def _weighted(synth, db, ids):
    f64 = np.float64
    fw = ((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt
    jl = ((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    jr = ((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    return fw.astype(f64), jl.astype(f64), jr.astype(f64)


def _path_cost64(cfg, db, synth, tgt, ids, jcw=None):
    """Float64 target + join cost of a unit path (tests/test_torch_synth.py)."""
    jcw = cfg.join_cost_weight if jcw is None else jcw
    tw = ((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt
    fw, jl, jr = _weighted(synth, db, ids)
    return (np.sqrt(((fw - tw) ** 2).sum(-1)).sum()
            + jcw * np.sqrt(((jl[1:] - jr[:-1]) ** 2).sum(-1)).sum())


def _jax_join_noise(db, synth, ids, jcw):
    """The f32 cancellation bound of the JAX Viterbi's join distances on a
    path: per join sqrt(16 ulp of |r|^2 + |l|^2) (tests/test_torch_synth.py)."""
    _, jl, jr = _weighted(synth, db, ids)
    eps = float(np.finfo(np.float32).eps)
    return jcw * np.sqrt(16 * eps * ((jl[1:] ** 2).sum(-1) + (jr[:-1] ** 2).sum(-1))).sum()


def _judge(cfg, db, synth, tgt, ids, cost, ref_ids, wave=None, ref_wave=None):
    """The tolerances of the module docstring: ``ids`` / ``cost`` / ``wave``
    the port's, ``ref_*`` the other side's, ``tgt`` the unit-rate targets."""
    c64 = _path_cost64(cfg, db, synth, tgt, ids)
    np.testing.assert_allclose(cost, c64, rtol=1e-5, atol=1e-4)
    if np.array_equal(ids, ref_ids):
        if wave is not None:
            assert len(wave) == len(ref_wave)
            np.testing.assert_allclose(wave, ref_wave, atol=1e-5)
        return
    c_ref = _path_cost64(cfg, db, synth, tgt, ref_ids)
    assert c64 <= c_ref * (1 + 1e-6), (c64, c_ref)
    assert (ids == ref_ids).mean() >= 0.9


def _arrays(synth, db, n_db, pad=512):
    """Raw blocks (with the baked sqn column), padded cut points and Mp for an
    n_db-way placement: with the toy voice's 597 units and 512-row shard
    units, the second shard is partly padding and shards 2, 3 (at n_db 4)
    wholly."""
    m = db.n_units
    mp = utils.next_multiple(m, pad * n_db)
    blocks, _, _ = build_raw_blocks(db.unit_features, db.join_right, mp, ndb=n_db,
                                    affine=(db.mean_target, db.std_target, synth._sqrt_wt))
    cut1 = np.pad(db.cutpoints[:, 1].astype(np.int32), (0, mp - m))
    cut2 = np.pad(db.cutpoints[:, 2].astype(np.int32), (0, mp - m))
    return blocks, cut1, cut2, mp


def _affines(synth, db):
    return (db.mean_target.astype(np.float32), db.std_target.astype(np.float32),
            synth._sqrt_wt, db.mean_join.astype(np.float32), db.std_join.astype(np.float32),
            synth._sqrt_wj)


def _batch(synth, db, utts, n=B, t=T):
    tgts = np.zeros((n, t, db.target_dim), np.float32)
    lengths = np.zeros(n, np.int32)
    for b in range(n):
        tu, k = synth.targets_from_features(utts[b % len(utts)].features)
        k = min(k, t)
        tgts[b, :k] = tu[:k]
        lengths[b] = k
    return tgts, lengths


def _both_steps(cfg, db, synth, n_data, n_db, tgts, lengths, *, greedy=False):
    """JAX's and the port's batched_synth_step on the same arrays: (port
    outputs, JAX outputs) as numpy."""
    blocks, cut1, cut2, mp = _arrays(synth, db, n_db)
    aff = _affines(synth, db)
    waves = db.waves.astype(np.float32)
    out_len = utils.next_multiple(tgts.shape[1] * synth.max_span + 2 * cfg.taper_length, 128)
    common = dict(n_cand=cfg.n_candidates, max_frag=synth.max_frag, out_len=out_len,
                  taper=cfg.taper_length, greedy=greedy)
    jmesh = jax_make_mesh(n_data, n_db, devices=jax.devices()[:n_data * n_db])
    jsv = jax_shard_voice(jmesh, blocks, cut1, cut2, waves, *aff, n_real=np.int32(db.n_units))
    ref = jax_step(jsv, jnp.asarray(tgts), jnp.asarray(lengths),
                   jnp.float32(cfg.join_cost_weight), jnp.float32(cfg.search_epsilon),
                   mesh=jmesh, chunk=512, **common)
    mesh = make_mesh(n_data, n_db, devices=["cpu"] * (n_data * n_db))
    sv = shard_voice(mesh, blocks, cut1, cut2, waves, *aff, n_real=db.n_units)
    got = batched_synth_step(sv, torch.from_numpy(tgts), torch.from_numpy(lengths),
                             cfg.join_cost_weight, cfg.search_epsilon, mesh=mesh, **common)
    return [t.numpy() for t in got], [np.asarray(a) for a in ref]


# ------------------------------------------------------------------ make_mesh
MESH_ARGS = [(0, 1, 8), (8, 1, 8), (4, 2, 8), (2, 4, 8), (0, 2, 8), (1, 1, 1),
             (0, 3, 8), (3, 2, 8), (2, 0, 8)]


@pytest.mark.parametrize("n_data,n_db,n", MESH_ARGS)
def test_make_mesh_matches_jax(n_data, n_db, n):
    """The same shapes as the JAX make_mesh on n devices, and the same
    ValueErrors; members in row-major order, repeats allowed."""
    try:
        want = jax_make_mesh(n_data, n_db, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("=")[0]):
            make_mesh(n_data, n_db, devices=["cpu"] * n)
        return
    got = make_mesh(n_data, n_db, devices=["cpu"] * n)
    assert got.shape == dict(want.shape)
    assert got.size == n and got.distinct() == [torch.device("cpu")]
    assert all(dev == torch.device("cpu") for row in got.devices for dev in row)


def test_make_mesh_needs_cuda_and_enough_cards(monkeypatch):
    """make_mesh() takes CUDA cards and never falls back: without CUDA, or
    with fewer cards than members, it raises; a CUDA member without CUDA
    raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2, 2, devices=["cuda:0"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        make_mesh(2, 2)
    assert make_mesh(1, 1).devices == ((torch.device("cuda", 0),),)


# ------------------------------------------------------- the batched step
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_batched_step_matches_jax(voice, singles, mesh_shape):
    """Port vs JAX batched_synth_step on the toy voice (B = 8, T = 256, the
    utterances repeated): ids, costs and audio by the module's tolerances;
    at (2, 4) shards 2 and 3 hold only padding rows and are searched all the
    same."""
    cfg, db, utts, synth = voice
    tgts, lengths = _batch(synth, db, utts)
    (ids, costs, audio, totals), (ids_j, _, audio_j, totals_j) = _both_steps(
        cfg, db, synth, *mesh_shape, tgts, lengths)
    for b in range(B):
        n = lengths[b]
        _judge(cfg, db, synth, tgts[b, :n], ids[b, :n], costs[b], ids_j[b, :n],
               audio[b, :totals[b]], audio_j[b, :totals_j[b]])
        single = singles[b % len(utts)]
        if n == single["n_units"]:
            np.testing.assert_array_equal(ids[b, :n], single["unit_ids"])
    # no unit past the real rows; every member received candidates
    assert (ids < db.n_units).all()
    n_data, n_db = mesh_shape
    assert len(sharded.EXCHANGE_BYTES) == (0 if n_db == 1 else n_data * n_db)


def test_greedy_step_matches_jax(voice):
    cfg, db, utts, synth = voice
    tgts, lengths = _batch(synth, db, utts)
    (ids, costs, audio, totals), (ids_j, costs_j, audio_j, totals_j) = _both_steps(
        cfg, db, synth, 4, 2, tgts, lengths, greedy=True)
    np.testing.assert_array_equal(ids, ids_j)
    np.testing.assert_array_equal(totals, totals_j)
    np.testing.assert_allclose(costs, costs_j, rtol=1e-5)
    for b in range(B):
        np.testing.assert_allclose(audio[b, :totals[b]], audio_j[b, :totals[b]], atol=1e-5)


def test_halfphone_merged_matches_jax_pallas_interpret():
    """A merged halfphone two-voice DB through batched_synth_step on a (2, 2)
    mesh against the JAX step with the Pallas kernel in interpret mode
    (tests/test_parallel.py:97-193): the same ids, costs to rtol 1e-5, the
    same sample totals, the partition respected and identities matched."""
    base_cfg = toy_config(target_representation="halfphone", n_candidates=6)
    utts_a = prepare_toy_utts(2, halfphone=True, seed0=100)
    utts_b = prepare_toy_utts(2, halfphone=True, seed0=500)
    merged = merge_voicedbs([build_voicedb(base_cfg, utts_a), build_voicedb(base_cfg, utts_b)],
                            names=["va", "vb"])
    synth = Synthesiser(base_cfg, merged, device="cpu")
    m, mp = merged.n_units, utils.next_multiple(merged.n_units, 4096 * 2)
    pad = mp - m
    blocks, _, _ = build_raw_blocks(merged.unit_features, merged.join_right, mp, ndb=2,
                                    affine=(merged.mean_target, merged.std_target,
                                            synth._sqrt_wt))
    kw = dict(n_real=np.int32(m),
              part=np.pad(merged.voice_ids.astype(np.int32), (0, pad), constant_values=-1),
              codes=np.pad(merged.unit_code.astype(np.int32), (0, pad), constant_values=-1),
              ctx=np.pad(merged.context_codes.astype(np.int32), ((0, pad), (0, 0)),
                         constant_values=-1))
    cuts = [np.pad(merged.cutpoints[:, c].astype(np.int32), (0, pad)) for c in (1, 2)]
    args = (blocks, *cuts, merged.waves.astype(np.float32), *_affines(synth, merged))

    b_n, t_n = 4, 32
    tgts = np.zeros((b_n, t_n, merged.target_dim), np.float32)
    lengths = np.zeros(b_n, np.int32)
    tcodes = np.full((b_n, t_n), -1, np.int32)
    tctx = np.full((b_n, t_n, 5), -1, np.int32)
    vids = np.array([0, 1, 0, 1], np.int32)
    for b, utt in enumerate([utts_a[0], utts_b[0], utts_a[1], utts_b[1]]):
        tgt, kept = synth.halfphone_targets_from_features(utt.features, utt.epochs,
                                                          utt.halfphones)
        n = min(len(tgt), t_n)
        tgts[b, :n], lengths[b] = tgt[:n], n
        tcodes[b, :n] = [synth._unit_vocab.get(s.name, -1) for s in kept[:n]]
        tctx[b, :n] = [[synth._phone_vocab.get(p, 0) for p in s.quinphone] for s in kept[:n]]
    common = dict(n_cand=6, max_frag=1024, out_len=utils.next_multiple(t_n * 400 + 100, 128),
                  taper=base_cfg.taper_length, halfphone=True,
                  ling_weights=synth._ling_weights())

    jmesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    ref = jax_step(jax_shard_voice(jmesh, *args, **kw), jnp.asarray(tgts),
                   jnp.asarray(lengths), jnp.float32(1.0), jnp.float32(0.0),
                   jnp.asarray(vids), jnp.asarray(tcodes), jnp.asarray(tctx), mesh=jmesh,
                   chunk=512, use_pallas=True, pallas_interpret=True, **common)
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    got = batched_synth_step(shard_voice(mesh, *args, **kw), torch.from_numpy(tgts),
                             torch.from_numpy(lengths), 1.0, 0.0, torch.from_numpy(vids),
                             torch.from_numpy(tcodes), torch.from_numpy(tctx), mesh=mesh,
                             **common)
    ids, costs, _, totals = (t.numpy() for t in got)
    ids_j, costs_j, _, totals_j = (np.asarray(a) for a in ref)
    for b in range(b_n):
        n = lengths[b]
        np.testing.assert_array_equal(ids[b, :n], ids_j[b, :n])
        assert (merged.voice_ids[ids[b, :n]] == vids[b]).all()
        known = tcodes[b, :n] >= 0
        assert (merged.unit_code[ids[b, :n]][known] == tcodes[b, :n][known]).all()
        c64 = _path_cost64(base_cfg, merged, synth, tgts[b, :n], ids[b, :n], jcw=1.0)
        np.testing.assert_allclose(costs[b], c64, rtol=1e-5, atol=1e-4)
        noise = _jax_join_noise(merged, synth, ids[b, :n], 1.0)
        assert abs(costs_j[b] - costs[b]) <= 1e-5 * abs(costs[b]) + noise
    np.testing.assert_array_equal(totals, totals_j)
    # the identity flags travelled with the candidates: one byte each
    k_local = 6 + preselect_margin(True, "highest", True, zero_transient=True)
    assert set(sharded.EXCHANGE_BYTES.values()) == {
        (b_n // 2) * t_n * k_local * (5 * 4 + 2 * merged.join_dim * 4 + 1)}


def test_wide_join_context_matches_jax():
    """join_context_frames=2 (dj = 2d) through the (2, 2) mesh: the raw-block
    exceptions, the exchange and the decode carry dj-wide contexts; the
    same ids as JAX's step (or a float64 near-tie)."""
    cfg = toy_config(multiepoch=2, join_context_frames=2)
    utts = prepare_toy_utts(3)
    db = build_voicedb(cfg, utts)
    synth = Synthesiser(cfg, db, device="cpu")
    assert db.join_dim == 2 * cfg.target_dim
    tgts, lengths = _batch(synth, db, utts, n=4, t=128)
    (ids, costs, audio, totals), (ids_j, _, audio_j, totals_j) = _both_steps(
        cfg, db, synth, 2, 2, tgts, lengths)
    for b in range(4):
        n = lengths[b]
        _judge(cfg, db, synth, tgts[b, :n], ids[b, :n], costs[b], ids_j[b, :n],
               audio[b, :totals[b]], audio_j[b, :totals_j[b]])


# ---------------------------------------------------------- Synthesiser
def _mesh_synth(cfg, db, n_data, n_db, **over):
    return Synthesiser(dataclasses.replace(cfg, mesh_data=n_data, mesh_db=n_db, **over), db,
                       device="cpu")


@pytest.mark.parametrize("over", [dict(zero_transient=0), dict(preselect_precision="split3cat"),
                                  dict(zero_transient=0, preselect_precision="split3cat")],
                         ids=["zt0-highest", "split3cat", "zt0-split3cat"])
def test_mesh_forms_match_the_single_device(voice, over):
    """The derived operand and split3cat on a (2, 2) mesh against the port's
    1x1 Synthesiser of the same config (tie-adjusted as the module says):
    each shard derives its own operand, with its own padding limit."""
    cfg, db, utts, _ = voice
    feats = [u.features for u in utts] + [prepare_toy_utts(1, seed0=900)[0].features]
    single = Synthesiser(dataclasses.replace(cfg, **over), db, device="cpu")
    mesh = _mesh_synth(cfg, db, 2, 2, **over)
    for f, a, b in zip(feats, mesh.synth_batch(feats), single.synth_batch(feats)):
        tgt = single.targets_from_features(f)[0]
        _judge(cfg, db, single, tgt, a["unit_ids"], a["total_cost"], b["unit_ids"],
               a["wave"], b["wave"])
    # 8,192 padded rows: shard 1 holds padding only (n_real 0 there)
    assert [db_j.n_real.item() for db_j in mesh._sharded_voice.members[1]] == [db.n_units, 0]


def test_host_ola_on_a_mesh(voice):
    """preload_all_waves=False on a (2, 2) mesh: the waves stay on the host
    (placeholders on the members) and the host OLA renders the mesh's ids,
    equal to the single device's."""
    cfg, db, utts, _ = voice
    feats = [u.features for u in utts[:3]]
    single = Synthesiser(dataclasses.replace(cfg, preload_all_waves=False), db, device="cpu")
    mesh = _mesh_synth(cfg, db, 2, 2, preload_all_waves=False)
    assert mesh._sharded_voice is None
    got = mesh.synth_batch(feats)
    assert mesh._sharded_voice.members[0][0].waves.numel() == 128
    for a, b in zip(got, single.synth_batch(feats)):
        np.testing.assert_array_equal(a["unit_ids"], b["unit_ids"])
        np.testing.assert_allclose(a["wave"], b["wave"], atol=1e-6)


def test_synth_batch_on_a_mesh_matches_jax(voice):
    """Synthesiser.synth_batch with config mesh_data 2 / mesh_db 2 against
    the JAX Synthesiser with the same config, on 5 utterances (padded with
    3 zero-length dummies to the mesh's 4)."""
    cfg, db, utts, _ = voice
    cfg_m = dataclasses.replace(cfg, mesh_data=2, mesh_db=2)
    feats = [u.features for u in utts] + [prepare_toy_utts(1, seed0=900)[0].features]
    ts, js = Synthesiser(cfg_m, db, device="cpu"), JaxSynthesiser(cfg_m, db=db)
    assert ts.n_units_padded == js.n_units_padded
    got, ref = ts.synth_batch(feats), js.synth_batch(feats)
    assert len(got) == len(ref) == 5
    for f, a, b in zip(feats, got, ref):
        tgt = ts.targets_from_features(f)[0]
        assert a["n_units"] == b["n_units"]
        _judge(cfg, db, ts, tgt, a["unit_ids"], a["total_cost"], b["unit_ids"], a["wave"],
               b["wave"])


def test_merged_voices_on_a_mesh():
    """Two merged epoch voices on a (1, 4) mesh (each shard holds rows of one
    voice, or padding): every unit from the utterance's own voice, ids equal
    to the single device's, 3 utterances padded to 4 with a dummy of voice
    id -1."""
    cfg, db_a, _ = build_toy_voice(halfphone=False, n_utts=2)
    _, db_b, _ = build_toy_voice(halfphone=False, n_utts=3)
    db = merge_voicedbs([db_a, db_b], names=["alice", "bob"])
    feats = [u.features for u in prepare_toy_utts(3, seed0=960)]
    voices = ["bob", "alice", "bob"]
    mesh = _mesh_synth(cfg, db, 1, 4)
    single = Synthesiser(cfg, db, device="cpu")
    for v, f, a, b in zip(voices, feats, mesh.synth_batch(feats, voices=voices),
                          single.synth_batch(feats, voices=voices)):
        assert (db.voice_ids[a["unit_ids"]] == single._voice_code(v)).all()
        _judge(cfg, db, single, single.targets_from_features(f)[0], a["unit_ids"],
               a["total_cost"], b["unit_ids"], a["wave"], b["wave"])


def test_synthesiser_mesh_devices(voice):
    """A device list names the members (repeats allowed); one of the wrong
    length, or a mesh on "cuda" without CUDA, raises."""
    cfg, db, utts, synth = voice
    ts = Synthesiser(dataclasses.replace(cfg, mesh_data=1, mesh_db=2), db,
                     device=["cpu", "cpu"])
    got = ts.synth_batch([utts[0].features])[0]
    np.testing.assert_array_equal(got["unit_ids"],
                                  synth.synth_from_features(utts[0].features)["unit_ids"])
    assert ts._mesh.shape == {"data": 1, "db": 2}
    with pytest.raises(ValueError, match="3 devices given for a mesh"):
        Synthesiser(dataclasses.replace(cfg, mesh_db=2), db, device=["cpu"] * 3)


# ------------------------------------------------------- server and CLI
def test_server_on_a_mesh(voice):
    """Three concurrent POST /synth to the port's server on a (2, 2) mesh
    Synthesiser: each answers the direct synth_from_features ids."""
    cfg, db, utts, synth = voice
    ts = _mesh_synth(cfg, db, 2, 2)
    httpd = SynthHTTPServer(ts, host="127.0.0.1", port=0, max_wait_ms=50.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/synth"

    def post(feats):
        req = urllib.request.Request(
            url, data=json.dumps({"features_b64": base64.b64encode(
                feats.astype(np.float32).tobytes()).decode()}).encode(),
            headers={"Content-Type": "application/json"})
        return json.load(urllib.request.urlopen(req, timeout=300))

    feats = [u.features for u in utts[:3]]
    try:
        out = [None] * 3
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, post(feats[i])))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
    for f, o in zip(feats, out):
        np.testing.assert_array_equal(np.asarray(o["unit_ids"]),
                                      synth.synth_from_features(f)["unit_ids"])
    assert ts._mesh is not None


def test_cli_on_a_mesh(voice, tmp_path):
    """`cli synth` on a config with mesh_data 1 / mesh_db 2 and synth_batch 2
    (DNN-target stream files): its units.npy equal direct calls."""
    cfg, db, _, synth = voice
    db.save(str(tmp_path / "work" / "meshtoy.voicedb"))
    held = prepare_toy_utts(3, seed0=985)
    slices = {"mag": (0, 60), "real": (60, 105), "imag": (105, 150), "lf0": (150, 151)}
    for i, u in enumerate(held):
        for s, (a, b) in slices.items():
            (tmp_path / "pred" / s).mkdir(parents=True, exist_ok=True)
            put_speech(u.features[:, a:b], str(tmp_path / "pred" / s / f"p{i}.{s}"))
    cfg_d = dataclasses.asdict(cfg)
    cfg_d.update(workdir=str(tmp_path / "work"), voice_name="meshtoy",
                 test_data_dir=str(tmp_path / "pred"), mesh_data=1, mesh_db=2, synth_batch=2)
    (tmp_path / "voice.json").write_text(json.dumps(cfg_d))
    out = tmp_path / "out"
    assert port_cli(["synth", "-c", str(tmp_path / "voice.json"), "-o", str(out),
                     "--dump-units", "--device", "cpu"]) == 0
    for i, u in enumerate(held):
        np.testing.assert_array_equal(np.load(out / f"p{i}.units.npy"),
                                      synth.synth_from_features(u.features)["unit_ids"])
    assert sharded.EXCHANGE_BYTES[0, 1] > 0


# ----------------------------------------------------- the exchange volume
def _port_payload(synth, db, cfg, n_data, n_db, b=B, t=T):
    """Bytes each member received in one step of zero targets, all of them
    live (every member receives the same)."""
    sharded.EXCHANGE_BYTES.clear()
    blocks, cut1, cut2, _ = _arrays(synth, db, n_db)
    mesh = make_mesh(n_data, n_db, devices=["cpu"] * (n_data * n_db))
    sv = shard_voice(mesh, blocks, cut1, cut2, db.waves.astype(np.float32),
                     *_affines(synth, db), n_real=db.n_units)
    out_len = utils.next_multiple(t * synth.max_span + 2 * cfg.taper_length, 128)
    batched_synth_step(sv, torch.zeros((b, t, db.target_dim)), torch.full((b,), t), 0.7, 0.0,
                       mesh=mesh, n_cand=30, max_frag=synth.max_frag, out_len=out_len,
                       taper=cfg.taper_length, do_ola=False)
    got = set(sharded.EXCHANGE_BYTES.values())
    assert len(got) <= 1 and len(sharded.EXCHANGE_BYTES) in (0, n_data * n_db)
    return got.pop() if got else 0


def test_exchange_payload_independent_of_ndb(voice):
    """tests/test_parallel.py:243: at a fixed data-parallel factor, widening
    the db axis leaves each member's exchange payload as it is (an
    all-gather would grow it ndb-fold); a db axis of 1 exchanges nothing;
    the payload grows linearly with the member's sub-batch."""
    cfg, db, _, synth = voice
    p22 = _port_payload(synth, db, cfg, 2, 2)
    p24 = _port_payload(synth, db, cfg, 2, 4)
    assert p22 > 0 and p22 == p24, (p22, p24)
    assert _port_payload(synth, db, cfg, 2, 1) == 0
    assert _port_payload(synth, db, cfg, 1, 4) == 2 * p24


def _jax_payload(synth, db, cfg, n_data, n_db, b=B, t=T):
    """Operand bytes of every all_to_all in JAX's traced step (each
    device's payload)."""
    mesh = jax_make_mesh(n_data, n_db, devices=jax.devices()[:n_data * n_db])
    blocks, cut1, cut2, _ = _arrays(synth, db, n_db)
    sv = jax_shard_voice(mesh, blocks, cut1, cut2, db.waves.astype(np.float32),
                         *_affines(synth, db), n_real=np.int32(db.n_units))
    out_len = utils.next_multiple(t * synth.max_span + 2 * cfg.taper_length, 128)
    closed = jax.make_jaxpr(functools.partial(
        jax_step, mesh=mesh, n_cand=30, chunk=512, max_frag=synth.max_frag, out_len=out_len,
        taper=cfg.taper_length))(sv, jnp.zeros((b, t, db.target_dim)),
                                 jnp.full((b,), t, jnp.int32), jnp.float32(0.7),
                                 jnp.float32(0.0))
    return _all_to_all_payload_bytes(closed.jaxpr)


def test_exchange_payload_matches_the_analytic_model(voice):
    """tests/test_parallel.py:261: rows x k x (5 four-byte fields + 2 dj
    f32), with rows = B_local x T and k the candidates each shard sends:
    k_local = n_cand + the rank margin (10) for the port's kernel, n_cand for
    JAX's XLA scan; the JAX step's traced payload meets the same model."""
    cfg, db, _, synth = voice
    rows, dj = (B // 2) * T, db.join_dim
    per_candidate = 5 * 4 + 2 * dj * 4
    assert _port_payload(synth, db, cfg, 2, 2) == rows * 40 * per_candidate
    assert _jax_payload(synth, db, cfg, 2, 2) == rows * 30 * per_candidate


# --------------------------------------------- norm stats and the dry run
def test_sharded_norm_stats_matches_jax(voice):
    cfg, db, utts, synth = voice
    feats = db.unit_features.astype(np.float32)
    mp = utils.next_multiple(len(feats), 8)
    padded = np.pad(feats, ((0, mp - len(feats)), (0, 0)))
    j_mean, j_std = jax_norm_stats(jnp.asarray(padded), jnp.float32(len(feats)),
                                   mesh=jax_make_mesh(4, 2))
    mean, std = sharded_norm_stats(padded, len(feats),
                                   mesh=make_mesh(4, 2, devices=["cpu"] * 8))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(j_std), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), feats.mean(0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(std.numpy(), feats.std(0), rtol=1e-3, atol=1e-3)


def test_dryrun_voice_is_the_graft_entry_voice():
    """The dry run's synthetic voice is a copy of the JAX entry's, bit for
    bit."""
    import __graft_entry__ as g
    for a, b in zip(synthetic_voice(4096, 32), g._synthetic_voice(4096, 32, 8)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_dryrun_multichip_on_cpu():
    """The dry run of __graft_entry__.dryrun_multichip at its shapes (131,072
    units, T 512) on 8 CPU members: a 4 x 2 mesh, both shards selected
    from."""
    got = dryrun_multichip(8, device="cpu")
    assert got == {"mesh": (4, 2), "units": 131_072, "batch": 8, "shards_hit": [0, 1]}


def test_mesh_is_a_value():
    """A mesh is a hashable value: equal meshes are interchangeable, and a
    voice sharded onto one mesh refuses another."""
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh == Mesh(((torch.device("cpu"),) * 2,) * 2) and hash(mesh) == hash(
        make_mesh(2, 2, devices=["cpu"] * 4))
    sv = shard_voice(mesh, np.zeros((8, 4), np.float32), np.zeros(4), np.zeros(4),
                     np.zeros(16), np.zeros(2), np.ones(2), np.ones(2))
    with pytest.raises(ValueError, match="another mesh"):
        batched_synth_step(sv, torch.zeros((4, 2, 2)), torch.ones(4), 1.0, 0.0,
                           mesh=make_mesh(4, 1, devices=["cpu"] * 4), n_cand=1,
                           max_frag=128, out_len=128, taper=1)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        batched_synth_step(sv, torch.zeros((3, 2, 2)), torch.ones(3), 1.0, 0.0, mesh=mesh,
                           n_cand=1, max_frag=128, out_len=128, taper=1)
