"""``python -m snickery_tpu_torch.sweep_topk --real [--cluster | --scatter]``
on the CPU, against ``scripts/bench_topk.py --real`` (loaded from its path):

- (a) ``cluster_order`` equal to the JAX script's bit for bit: below and
  above the sample size, over several assignment blocks, with empty
  clusters, and at the defaults;
- (b) the inputs the JAX script hands ``pallas_topk_preselect`` (captured by
  a stand-in) against ``make_real_data``'s, for ``--db-op norm | raw | zt``
  and each order (as built, ``--cluster``, ``--scatter``, both): the same
  targets, the same k-means order, the same DB rows (the zero-transient
  block's data and pointer columns, and its sqn column against the float64
  squared norm), the same affine and row count;
- (c) the Pallas kernel in interpret mode at "highest" on those captured
  inputs against the port's twin on its own (``kernel_check.judge``: the
  same ids except float64 near-ties of the k-th score, scores to
  ``SCORE_ATOL``);
- (d) ``main --real --device cpu`` on a small voice, as built and clustered,
  and scattered with both fused masks on ``--db-op raw``, the targets
  analysed by the bench's own ``held_out_features`` on the CPU (the bench's
  module state untouched): one line a combination and BEST;
- (e) the refusals and their exit codes; (f) ``--real --help`` with jax and
  the JAX package blocked;
- ``chip_smoke.py``'s phase 32 rehearsed on the CPU on the small voice.

The voice is three ``synth_utterance`` utterances built with the port
(2,304 units, about 8% of them bit-identical to another row), saved as
``bench1m.voicedb``; (b) and (c) give both benches the same held-out
features (noisy runs of the voice's rows: the two analyses differ by
design).
"""

import contextlib
import functools
import importlib.util
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from snickery_tpu import utils as jutils
from snickery_tpu.ops import pallas_topk
from snickery_tpu_torch import bench as tbench
from snickery_tpu_torch import sweep_topk
from snickery_tpu_torch.kernel_check import SCORE_ATOL, judge
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (derive_operand, topk_preselect_dv_plain,
                                              topk_preselect_zt_plain)
from snickery_tpu_torch.voicedb.build import build_voicedb
from snickery_tpu_torch.voicedb.db import VoiceDB

ROOT = Path(__file__).resolve().parents[1]
F32_EPS = float(np.finfo(np.float32).eps)
ROWS = 600                   # --rows: cut, then padded to 1,024 target rows
K = 30
ORDERS = {"built": (False, False), "cluster": (True, False), "scatter": (False, True),
          "cluster_scatter": (True, True)}
JAX_OPS = ("norm", "raw", "zt")
P = torch.from_numpy


@functools.lru_cache(maxsize=None)
def jax_script():
    """``scripts/bench_topk.py``, loaded from its path."""
    path = ROOT / "scripts" / "bench_topk.py"
    spec = importlib.util.spec_from_file_location("jax_bench_topk", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A bench cache holding a small port-built voice as ``bench1m``."""
    root = tmp_path_factory.mktemp("sweep_real")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tbench._STATE, "device", torch.device("cpu"))
        mp.setitem(tbench._STATE, "cache", str(root))
        utts = tbench.make_corpus(3, 40, 10_000, False)
        db = build_voicedb(tbench.bench_config(voice_name=sweep_topk.REAL_VOICE), utts)
    db.save(sweep_topk.real_voice_path(str(root)))
    return root


def held_out(cache):
    """A stand-in for both benches' ``held_out_features``: eight noisy runs
    of the voice's rows, seeded."""
    db = VoiceDB.load(sweep_topk.real_voice_path(str(cache)))
    rng = np.random.default_rng(5)
    feats = [db.unit_features[s:s + n] + 0.01 * rng.standard_normal((n, db.target_dim))
             .astype(np.float32)
             for s, n in zip(rng.integers(0, db.n_units - 160, 8), rng.integers(30, 150, 8))]

    def fn(n_utts, n_segments, seed0=90_000, device=None):
        assert (n_utts, n_segments, seed0) == (8, 128, 90_000)
        return [f.copy() for f in feats], None, None
    return fn


@functools.lru_cache(maxsize=None)
def inputs(cache, db_op: str, order: str):
    """(what the JAX script passed to ``pallas_topk_preselect``, the orders
    its ``cluster_order`` returned, the port's ``RealData``) for one
    operand form and order."""
    cluster, scatter = ORDERS[order]
    script = jax_script()
    got, orders = {}, []

    def capture(targets, db, k, **kw):
        got.update(targets=np.asarray(targets), db=np.array(db), k=k, **kw)
        return jnp.zeros((targets.shape[0], k), jnp.int32), jnp.zeros((targets.shape[0], k))

    def recorded(feats, *a, **kw):
        orders.append(cluster_order(feats, *a, **kw))
        return orders[-1]

    cluster_order = script.cluster_order
    stand_in = held_out(cache)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SNICKERY_BENCH_CACHE", str(cache))
        mp.setattr(pallas_topk, "pallas_topk_preselect", capture)
        mp.setattr(jutils, "enable_compilation_cache", lambda *a, **kw: None)
        mp.setattr(jbench, "held_out_features", stand_in)
        mp.setattr(script, "cluster_order", recorded)
        argv = ["--real", "--db-op", db_op, "--rows", str(ROWS), "--iters", "1",
                "--combos", "256,4096,128,highest,stream"]
        with contextlib.redirect_stdout(io.StringIO()):
            assert script.main(argv + ["--cluster"] * cluster + ["--scatter"] * scatter) == 0
        mp.setattr(tbench, "held_out_features", stand_in)
        data = sweep_topk.make_real_data(str(cache), ROWS, db_op, cluster, scatter,
                                         torch.device("cpu"))
    return got, orders, data


# --------------------------------------------------------------- (a) k-means
@pytest.mark.parametrize("case", ["below_sample", "above_sample_blocks", "empty_clusters",
                                  "defaults"])
def test_cluster_order_equals_the_jax_scripts(case):
    rng = np.random.default_rng(len(case))
    kw = {}
    if case == "below_sample":
        feats, kw = rng.standard_normal((300, 24)).astype(np.float32), dict(
            n_clusters=32, sample=1000, iters=5, seed=3)
    elif case == "above_sample_blocks":       # two blocks of the assignment
        feats, kw = rng.standard_normal((70_000, 6)).astype(np.float32), dict(
            n_clusters=40, sample=5000, iters=4)
    elif case == "empty_clusters":            # 81 distinct rows, 128 centroids
        feats = rng.integers(0, 3, (2000, 4)).astype(np.float32)
        kw = dict(n_clusters=128, sample=1500)
        assert len(np.unique(feats, axis=0)) < kw["n_clusters"]
    else:
        feats = rng.standard_normal((3000, 16)).astype(np.float32)
    got = sweep_topk.cluster_order(feats, **kw)
    want = jax_script().cluster_order(feats, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(len(feats)))


# --------------------------------------------------- (b) the --real inputs
@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("db_op", JAX_OPS)
def test_real_inputs_equal_the_jax_scripts(cache, db_op, order):
    jx, orders, data = inputs(cache, db_op, order)
    cluster, scatter = ORDERS[order]
    kd, n, mp = data.targets.shape[1], data.n_units, data.m_rows
    assert data.targets.shape == jx["targets"].shape == (1024, kd) and jx["k"] == K
    np.testing.assert_allclose(data.targets, jx["targets"], rtol=F32_EPS, atol=0)
    assert not data.targets[ROWS:].any()
    assert mp == 8192 and n == 2304 and data.raw.shape[1] == kd + 2
    assert data.how == {"built": "built", "cluster": "clustered", "scatter": "scattered",
                        "cluster_scatter": "clustered, scattered"}[order]
    assert len(orders) == cluster
    if cluster:
        assert data.cluster_s > 0.0
        want = orders[0][sweep_topk.scatter_order(n)] if scatter else orders[0]
        assert np.array_equal(data.order, want)
    elif scatter:
        assert np.array_equal(data.order, sweep_topk.scatter_order(n))
    else:
        assert data.order is None
    aff = tuple(map(P, data.aff))
    if db_op == "norm":
        op, _ = derive_operand(P(data.raw), aff, n, mp, "highest")
        assert jx["db_affine"] is None and not jx["zero_transient"] and jx["m_rows"] is None
        np.testing.assert_array_equal(op.numpy(), jx["db"])
        return
    mean, std, ones, n_real = (np.asarray(a) for a in jx["db_affine"])
    for a, b in zip((mean, std, ones), data.aff):
        np.testing.assert_array_equal(a, b)
    assert int(n_real) == n
    if db_op == "raw":
        assert not jx["zero_transient"] and jx["m_rows"] is None
        assert jx["db"].shape == (mp, kd)
        np.testing.assert_array_equal(data.raw[:mp, :kd], jx["db"])
        return
    assert jx["zero_transient"] and jx["m_rows"] == mp
    assert jx["db"].shape == (data.raw.shape[0], kd + 1)       # [data | ptr]
    np.testing.assert_array_equal(data.raw[:, :kd], jx["db"][:, :kd])
    np.testing.assert_array_equal(data.raw[:, -1].view(np.int32), jx["db"][:, -1].view(np.int32))
    x = (jx["db"][:n, :kd].astype(np.float64) - mean) / std
    np.testing.assert_allclose(data.raw[:n, kd], (x * x).sum(-1), rtol=4 * kd * F32_EPS)


# --------------------------------- (c) the Pallas kernel against the port's twin
@pytest.mark.parametrize("order", ["built", "cluster"])
@pytest.mark.parametrize("db_op", JAX_OPS)
def test_pallas_interpret_on_the_real_inputs_matches_the_twin(cache, db_op, order):
    jx, _, data = inputs(cache, db_op, order)
    kw = {k: v for k, v in jx.items() if k not in ("targets", "db", "k")}
    kw.update(interpret=True, mm_precision="highest", sort=True)
    ri, rv = pallas_topk.pallas_topk_preselect(jnp.asarray(jx["targets"]),
                                               jnp.asarray(jx["db"]), K, **kw)
    want_i, want_v = P(np.array(ri)), P(np.array(rv))
    targets, aff, mp = P(data.targets), tuple(map(P, data.aff)), data.m_rows
    if db_op == "zt":
        block, block_aff, sqn = P(data.raw), aff, None
        got = topk_preselect_zt_plain(targets, block, K, aff, mp)
    else:
        block, sqn = derive_operand(P(data.raw), aff, data.n_units, mp, "highest")
        block_aff = None
        got = topk_preselect_dv_plain(targets, block, sqn, K, mp)
    # the JAX kernel's result held to the port's twin, as a card kernel is
    err, n_bad, dead = judge((want_i, want_v), got, targets, block, block_aff, mp, "highest",
                             sqn=sqn, n_real=data.n_units)
    assert err <= SCORE_ATOL and dead == 0 and n_bad <= 0.01 * len(targets)


# ---------------------------------------------------------------- (d) main
MAIN_CASES = {"built": ["--db-op", "dv"], "cluster": ["--db-op", "dv", "--cluster"],
              "scatter": ["--db-op", "raw", "--scatter", "--masks", "ling_part"]}


@pytest.mark.parametrize("order", sorted(MAIN_CASES))
def test_main_real_on_cpu_prints_a_line_a_combination(cache, capsys, order):
    """As built and clustered on the derived operand, and scattered on the
    operand derived in every call with both fused masks."""
    combos = "highest,stream split3cat,packed highest,packed3diag"
    argv = ["--real", "--device", "cpu", "--cache-dir", str(cache), "--rows", "200",
            "--iters", "1", "--combos", combos]
    state = dict(tbench._STATE)
    assert sweep_topk.main(argv + MAIN_CASES[order]) == 0
    assert tbench._STATE == state, "the sweep wrote into the bench's module state"
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 4 and lines[-1].startswith("BEST: ")
    for line, combo in zip(lines, combos.split()):
        assert line.split(":")[0].split() == combo.split(",") and line.rstrip().endswith(
            ("ms", "cols"))
    assert "overflow" in lines[2] and "/1024 cols" in lines[2]
    header = next(ln for ln in err.splitlines() if "target rows" in ln)
    assert header.startswith("# 1024 target rows x 8192 units x 151 dims, k 30, db-op "
                             + MAIN_CASES[order][1])
    assert "real bench1m (2304 units" in header and "clustering" in header
    assert {"built": "built,", "cluster": "clustered,", "scatter": "scattered,"}[order] in header


# ----------------------------------------------------------- (e) refusals
@pytest.mark.parametrize("case", ["cluster_without_real", "pileup_with_real", "no_voice"])
def test_refusals(tmp_path, capsys, case):
    argv = ["--device", "cpu", "--cache-dir", str(tmp_path)]
    if case == "no_voice":
        assert sweep_topk.main(argv + ["--real"]) == 2
        msg = capsys.readouterr().err
        assert ("no cached bench1m voice" in msg
                and "python -m snickery_tpu_torch.bench --modes epoch --cache-dir" in msg)
        return
    extra = ["--cluster"] if case == "cluster_without_real" else ["--real", "--pileup", "6"]
    with pytest.raises(SystemExit) as e:
        sweep_topk.main(argv + extra)
    assert e.value.code == 2
    assert ("needs --real" if case == "cluster_without_real" else "carries its own") in (
        capsys.readouterr().err)


# ------------------------------------------------------ (f) help, jax blocked
def test_real_help_runs_with_jax_blocked():
    """``python -m snickery_tpu_torch.sweep_topk --real --help`` with jax,
    the JAX package, ``bench`` and ``tests`` blocked; none gets loaded."""
    code = (
        "import runpy, sys\n"
        "def blocked(name):\n"
        "    return (name in ('jax', 'jaxlib', 'snickery_tpu', 'bench', 'tests')\n"
        "            or name.startswith(('jax.', 'jaxlib.', 'snickery_tpu.', 'tests.')))\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if blocked(name):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['snickery_tpu_torch.sweep_topk', '--real', '--help']\n"
        "try:\n"
        "    runpy.run_module('snickery_tpu_torch.sweep_topk', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "assert not any(blocked(m) for m in sys.modules), sorted(m for m in sys.modules if blocked(m))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    for flag in ("--real", "--cluster", "--cache-dir", "--scatter", "--db-op", "norm", "raw"):
        assert flag in res.stdout, flag


# ------------------------------------------------- chip_smoke.py's phase 32
class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_chip_smoke_real_sweep_phase_rehearses_on_the_cpu(cache, monkeypatch, capsys):
    """Phase 32 on the CPU on the small voice, one timed call a combination
    and the slice checks on 512 targets: the seven sweeps print one line a
    combination (logged as one JSON line), every check passes, and the
    ``@real`` rows carry the sweep's launches of the two stream kernels.
    On the CPU no kernel launches, so a counting wrapper around the sweep's
    ``cuda_topk_preselect`` stands in for the wrappers' counts, and the
    host clock for CUDA events."""
    import chip_smoke as smoke
    monkeypatch.setattr(smoke, "BENCH_CACHE", str(cache))
    monkeypatch.setattr(smoke, "REAL_SLICE", 512)
    monkeypatch.setattr(tbench, "held_out_features", held_out(cache))
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    main, preselect = sweep_topk.main, sweep_topk.cuda_topk_preselect

    def counted(targets, raw_block, k, db_affine, m_rows, **kw):
        name = cuda_topk.kernel_name(False, False, kw["precision"],
                                     kw.get("zero_transient", True), kw["select"])
        cuda_topk.LAUNCH_COUNTS[name] += 1
        return preselect(targets, raw_block, k, db_affine, m_rows, **kw)

    monkeypatch.setattr(sweep_topk, "cuda_topk_preselect", counted)
    monkeypatch.setattr(sweep_topk, "main", lambda argv: main([*argv, "--iters", "1"]))
    run = smoke.Run(torch)
    smoke.real_sweep_phase(run, "cpu", device="cpu")
    log = capsys.readouterr().out
    table = json.loads(next(ln for ln in log.splitlines()
                            if ln.startswith('{"real_sweep"')))["real_sweep"]
    assert len(table) == len(smoke.REAL_RUNS) * len(smoke.REAL_COMBOS)
    assert {(r["db_op"], r["order"]) for r in table} == set(smoke.REAL_RUNS)
    assert all((r["overflow"] is None) == (r["select"] != "packed3diag") for r in table)
    assert "clustered vs built through the order" in log and "phase 32 took" in log
    for row in smoke.REAL_ROWS:
        assert run.launches[row] == 3 * 2           # three orders, a warm-up and a call
        assert run.shapes[row] == "1024 x 8192 x 151, k 30" and run.errs[row] <= SCORE_ATOL
        assert run.bounds[row][0] > 0 and run.matmul[row] > 0
    assert run.launches["topk_preselect_dv_split3cat_packed3"] == 4 * 2
