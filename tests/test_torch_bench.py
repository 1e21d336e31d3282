"""The port's bench (``snickery_tpu_torch.bench``): its one result line, its
exit codes and where it writes, on the CPU.

The line is held to ``bench.py``'s contract (tests/test_bench_line.py):
with every block populated and an error and a budget skip for every mode it
stays within 1,500 characters of strict JSON, NaN becomes null, and the
compact ``extra`` equals the JAX bench's ``_compact_extra`` on the same
blocks, with ``pallas_compiled_vs_interpret`` named ``kernel_vs_twin`` and
``detail`` naming the port's record.  A mode that raises makes the exit code
1; a skip for lack of budget is the one clean gap.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import bench as jbench
from snickery_tpu_torch import bench as tbench

ROOT = Path(__file__).resolve().parents[1]
LONG_OUT = "/" + "/".join(["a_rather_long_directory_name"] * 5) + "/BENCH_full.json"


def _worst_case() -> dict:
    """tests/test_bench_line.py's fattest record, every port block, an error
    and a budget skip for every mode, both kill flags."""
    full = {
        "device": "NVIDIA H100 80GB HBM3, 700.00 W",
        "run_id": "0123456789ab",
        "config3": {"rtf": 0.0015570367116338883, "ms_per_step": 965.4769897460938,
                    "ms_per_step_min": 960.1, "ms_per_step_max": 1970.2,
                    "step_ms": [965.4] * 5, "single_step_latency_ms": 970.0,
                    "n_units": 1049787, "batch": 32, "bucket_T": 2048,
                    "agreement_vs_f32": 0.919247269583116,
                    "agreement_vs_f32_tie_adjusted": 0.9799471634347645,
                    "f32_gate_worst_cost_gap_rel": 0.0010672838678415,
                    "agreement_vs_f64_oracle": 0.98125,
                    "agreement_tie_adjusted": 1.0,
                    "oracle_path_cost_gap_rel": 0.0,
                    "launches_per_step": {"topk_preselect_zt_split3cat": 1.0},
                    "profile": {"device_busy_share": 0.61, "device_kernels": 41000}},
        "mode_sec": {m: 132.9 for m in tbench.MODES},
        "kernel_vs_twin": True,
        "kernel_check": {"cases": [{"case": "config3_batch", "ms": 246.3}], "kernel_ms": 246.3},
        "config4": {"chunk_latency_p50_ms": 44.762372970581055,
                    "chunk_latency_p95_ms": 52.58030891418456,
                    "rtf": 0.23505622259279718, "input": "fixed_rate_dnn_style",
                    "frameshift_ms": 5.0, "chunk_frames": 32, "device_ms": 3.2,
                    "rtt_ms": 0.01, "payload_fetch_ms": 0.05},
        "config4_natural": {"chunk_latency_p50_ms": 72.07393646240234,
                            "chunk_latency_p95_ms": 89.1552448272705,
                            "rtf": 0.2482205042430162, "chunk_units": 32},
        "config2": {"rtf": 0.0006780096534251438, "ms_per_step": 16.269731521606445,
                    "n_units": 50000, "halfphone_identity_match": 1.0,
                    "agreement_vs_f64_oracle": 1.0, "agreement_tie_adjusted": 1.0,
                    "oracle_path_cost_gap_rel": 0.0},
        "config5": {"rtf": 0.0009457989886347744, "ms_per_step": 145.9263801574707,
                    "batch": 64, "n_voices": 8, "cross_voice_leaks": 0},
        "config1": {"latency_ms": 101.21798515319824, "n_units": 38507,
                    "audio_sec": 5.241875, "held_out_mcd_db": 28.018917688746672,
                    "natural_reconstruction_mcd_db": 4.018429116045569,
                    "held_out_ffe": 0.24260360414471183,
                    "held_out_f0_rmse_hz": 18.828201293945312,
                    "join_flux_ratio": 1.1633540578985058, "n_nonnatural_joins": 408},
        "config_48k": {"latency_ms": 353.21366786956787, "rtf": 0.058809114538817306,
                       "n_units": 13553, "sample_rate": 48000,
                       "agreement_vs_f64_oracle": 0.9984301412872841,
                       "agreement_tie_adjusted": 1.0, "oracle_path_cost_gap_rel": 0.0},
        "config3_me2": {"rtf": 0.0010842294344135682, "ms_per_step": 679.1094779968262,
                        "n_units": 1049787, "multiepoch": 2,
                        "agreement_vs_f32": 0.99991,
                        "agreement_vs_f32_tie_adjusted": 0.9999612487792969,
                        "f32_gate_worst_cost_gap_rel": 2.3374992573611895e-05,
                        "agreement_vs_f64_oracle": 0.998046875,
                        "agreement_tie_adjusted": 0.998046875,
                        "oracle_path_cost_gap_rel": 2.4524986784781213e-07,
                        "kernel_at_shape": {"ms": 120.5, "plain_ms": 1400.0}},
        "capacity": {"n_units": 8388608, "rtf": 0.0123, "hbm_bytes_in_use_gb": 7.91,
                     "agreement_split3_vs_highest": 0.99997, "agreement_tie_adjusted": 1.0},
        "quality_trend": [
            {"voice": "benchtoy", "n_units": 38507, "held_out_mcd_db": 28.018917688746672,
             "ffe": 0.24260360414471183, "join_flux_ratio": 1.2755226782012734},
            {"voice": "benchmid", "n_units": 169129, "held_out_mcd_db": 23.046178243539163,
             "ffe": 0.2141776499525352, "join_flux_ratio": 1.4153593415889691},
            {"voice": "bench1m", "n_units": 1047824, "held_out_mcd_db": 17.79146468432565,
             "ffe": 0.16401088989500665, "join_flux_ratio": 1.3976395665941748}],
        "bench_elapsed_sec": 387.5,
        "killed_by_signal": 15,
        "killed_by_watchdog": 1199.9,
    }
    for mode in tbench.MODES:
        full[mode + "_error"] = "RuntimeError: " + "x" * 200
        full[mode + "_skipped"] = "budget"
    return full


@pytest.fixture
def state(monkeypatch, tmp_path):
    """A fresh bench state on the CPU with its cache under ``tmp_path``."""
    monkeypatch.setattr(tbench, "_STATE", tbench._fresh_state())
    tbench._STATE.update(device=torch.device("cpu"), cache=str(tmp_path / "cache"))
    return tbench._STATE


def test_final_line_fits_and_is_strict_json(state):
    state.update(extra=_worst_case(), rtf=0.0015570367116338883, out=LONG_OUT)
    line = tbench._result_line()
    assert len(line) <= 1500, f"final line is {len(line)} chars: {line}"
    parsed = json.loads(line)
    assert parsed["metric"] == "synthesis_rtf"
    assert parsed["unit"] == "wall_sec_per_audio_sec"
    assert parsed["vs_baseline"] == pytest.approx(0.0015570367116338883 / 0.003)
    extra = parsed["extra"]
    assert extra["detail"] == LONG_OUT
    assert extra["kernel_vs_twin"] is True
    assert "pallas_compiled_vs_interpret" not in extra
    assert extra["config3"]["agreement_tie_adjusted"] == 1.0
    assert "agreement_vs_f32_tie_adjusted" in extra["config3_me2"]
    assert set(extra["errors"]) == set(tbench.MODES)
    assert extra["errors"]["kernel"] == "RuntimeError"
    assert sorted(extra["skipped"]) == sorted(tbench.MODES)
    # the full record keeps everything
    full = json.loads(tbench._full_line())
    assert full["extra"]["config3"]["step_ms"] == [965.4] * 5
    assert len(full["extra"]["quality_trend"]) == 3


def test_nan_becomes_null(state):
    state.update(extra={"config3": {"rtf": float("nan"), "ms_per_step": float("inf")}},
                 rtf=float("nan"))
    parsed = json.loads(tbench._result_line())
    assert parsed["value"] is None and parsed["vs_baseline"] is None
    assert parsed["extra"]["config3"]["rtf"] is None
    assert json.loads(tbench._full_line())["extra"]["config3"]["ms_per_step"] is None


def test_compact_extra_equals_the_jax_benchs(state, monkeypatch):
    """On the same blocks the port's compact extra is the JAX bench's, with
    ``pallas_compiled_vs_interpret`` renamed ``kernel_vs_twin`` and
    ``detail`` naming the port's record."""
    extra = _worst_case()
    jax_extra = {("pallas_compiled_vs_interpret" if k == "kernel_vs_twin" else k): v
                 for k, v in extra.items()}
    state.update(extra=extra, out=LONG_OUT)
    monkeypatch.setitem(jbench._STATE, "extra", jax_extra)
    got = tbench._compact_extra()
    want = {("kernel_vs_twin" if k == "pallas_compiled_vs_interpret" else k): v
            for k, v in jbench._compact_extra().items()}
    assert want.pop("detail") == "BENCH_full.json"
    assert got.pop("detail") == LONG_OUT
    assert got == want
    assert list(got) == list(want)
    # and with no out path the detail is the cache's record
    state["out"] = None
    assert tbench._compact_extra()["detail"] == os.path.join(state["cache"], "BENCH_full.json")


def _run(monkeypatch, capsys, argv):
    rc = tbench.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def test_a_mode_that_raises_exits_1(monkeypatch, capsys, tmp_path):
    def boom(args, extra):
        raise RuntimeError("the toy mode failed")
    monkeypatch.setattr(tbench, "run_toy_mode", boom)
    rc, line = _run(monkeypatch, capsys, ["--modes", "toy", "--cache-dir", str(tmp_path),
                                          "--budget-sec", "0"])
    assert rc == 1
    assert line["extra"]["errors"] == {"toy": "RuntimeError"}
    full = json.loads((tmp_path / "BENCH_full.json").read_text())
    assert full["extra"]["toy_error"] == "RuntimeError: the toy mode failed"


def test_a_budget_skip_exits_0(monkeypatch, capsys, tmp_path):
    def never(args, extra):
        raise AssertionError("a skipped mode ran")
    monkeypatch.setattr(tbench, "run_toy_mode", never)
    monkeypatch.setattr(tbench, "run_48k_mode", never)
    rc, line = _run(monkeypatch, capsys, ["--modes", "toy,48k", "--cache-dir", str(tmp_path),
                                          "--budget-sec", "0.001"])
    assert rc == 0
    assert line["extra"]["skipped"] == ["toy", "48k"]
    assert "errors" not in line["extra"]
    assert signal.alarm(0) == 0, "the bench left its alarm set"
    assert signal.getsignal(signal.SIGTERM) is not tbench._die_flushing


def test_streaming_without_the_epoch_mode_is_an_error(monkeypatch, capsys, tmp_path):
    rc, line = _run(monkeypatch, capsys, ["--modes", "streaming", "--cache-dir", str(tmp_path),
                                          "--budget-sec", "0"])
    assert rc == 1 and line["extra"]["errors"] == {"streaming": "RuntimeError"}


def _tree(root: Path) -> dict:
    """(size, mtime) of every file of the repository outside the build,
    cache and VCS directories."""
    skip = {".git", "build", "__pycache__", ".hypothesis", "chiprun_out", ".pytest_cache"}
    files = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in skip and not d.endswith(".egg-info")]
        for name in filenames:
            p = Path(dirpath) / name
            if p == ROOT / "native" / "libsnickery_native.so":
                continue           # the JAX package's own in-place build
            st = p.stat()
            files[str(p.relative_to(root))] = (st.st_size, st.st_mtime_ns)
    return files


def test_a_run_writes_nothing_in_the_repository(monkeypatch, capsys, tmp_path):
    """The records go to the cache dir (by default under ``~/.cache``) and to
    ``--out``; the repository, the JAX bench's BENCH_full.json included, is
    left as it was."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(ROOT)
    jax_record = hashlib.sha256((ROOT / "BENCH_full.json").read_bytes()).hexdigest()
    before = _tree(ROOT)
    out = tmp_path / "out" / "record.json"
    rc, line = _run(monkeypatch, capsys, ["--modes", "kernel", "--out", str(out),
                                          "--budget-sec", "0"])
    assert rc == 0 and line["extra"]["kernel_vs_twin"] is True
    assert _tree(ROOT) == before
    assert hashlib.sha256((ROOT / "BENCH_full.json").read_bytes()).hexdigest() == jax_record
    cache = home / ".cache" / "snickery_bench_torch"
    assert line["extra"]["detail"] == str(out)
    for path in (out, cache / "BENCH_full.json", cache / "BENCH_partial.json"):
        assert json.loads(path.read_text())["extra"]["kernel_vs_twin"] is True


def test_signal_and_watchdog_print_the_line_and_exit_nonzero(state, monkeypatch, capsys):
    exits = []

    monkeypatch.setattr(tbench.os, "_exit", exits.append)
    state.update(extra={"config3": {"rtf": 0.002}}, rtf=0.002)
    tbench._die_flushing(15, None)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert exits == [128 + 15] and line["extra"]["killed_by_signal"] == 15

    state.update(emitted=False, t0=time.time(), extra={})
    tbench._start_watchdog(0.0)
    deadline = time.time() + 30
    while not exits[1:] and time.time() < deadline:
        time.sleep(0.01)
    assert exits[1:] == [1]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "killed_by_watchdog" in line["extra"]
    stop = tbench._start_watchdog(3600.0)
    stop.set()


def test_cuda_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--modes", "kernel", "--cache-dir", str(tmp_path)])
    assert not (tmp_path / "BENCH_full.json").exists()


def test_help_runs_with_jax_blocked():
    """``python -m snickery_tpu_torch.bench --help`` with jax, the JAX
    package, ``bench`` and ``tests`` blocked; none of them gets loaded."""
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
        "sys.argv = ['snickery_tpu_torch.bench', '--help']\n"
        "try:\n"
        "    runpy.run_module('snickery_tpu_torch.bench', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "assert not any(blocked(m) for m in sys.modules), sorted(m for m in sys.modules if blocked(m))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "usage: snickery_tpu_torch.bench" in res.stdout
    for flag in ("--modes", "--units", "--cap-units", "--cap-tile", "--hp-units", "--mv-units",
                 "--mv-batch", "--batch", "--iters", "--stream-chunk", "--oracle-rows",
                 "--skip-oracle", "--rebuild", "--quick", "--profile", "--budget-sec",
                 "--device", "--cache-dir", "--out"):
        assert flag in res.stdout, flag


def test_flags_and_defaults_match_the_jax_bench():
    """``bench.py``'s flags keep their defaults; the port adds only
    ``--device``, ``--cache-dir`` and ``--out``, and names its kernel check
    ``kernel`` where the JAX bench says ``pallas``."""
    got = vars(tbench.parse_args([]))
    import argparse
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.update(vars(real(self, [])))
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            jbench.main([])
    assert set(got) == set(seen) | {"device", "cache_dir", "out"}
    for k, v in seen.items():
        want = v.replace("pallas", "kernel") if k == "modes" else v
        assert got[k] == want, k
    assert got["device"] == "cuda"
