"""What the benchmark may import: nothing of JAX or of the JAX package
``snickery_tpu`` anywhere (top-level module names compared whole, so the
port ``snickery_tpu_torch`` passes), and in the reference nothing of the
port either."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "snickery_tpu"}


def _imports(path: Path) -> set:
    """Top-level names of the modules a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts)


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not _imports(p) & JAX_NAMES, p


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "math", "numpy", "torch", "benchmark"}
    for p in _sources("reference"):
        names = _imports(p)
        assert names <= allowed, (p, names - allowed)
        text = p.read_text()
        assert "snickery_tpu_torch" not in [n for n in names]
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), (p, node.module)


BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = set(sys.argv[1].split(","))

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[2])
""")


def _blocked_python(blocked: set, body: str) -> subprocess.CompletedProcess:
    code = BLOCKER + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code, ",".join(sorted(blocked)), str(REPO)],
                          capture_output=True, text=True, timeout=600, cwd=REPO)


def test_a_run_loads_nothing_of_jax_or_the_jax_package(tmp_path):
    res = _blocked_python(JAX_NAMES, f"""
        from pathlib import Path
        from benchmark import registry, run
        from benchmark.tests import tiny
        root = tiny.make_root(Path({str(tmp_path)!r}))
        line, _ = run.run_cell(registry.cell(root, "tiny.batch"), 3, 0.5, True, device="cpu",
                               log=lambda m: None)
        import benchmark.control, benchmark.sweep_rate, benchmark.client
        assert line["correct"], line
        print("LOADED", run.forbidden_modules())
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout


def test_the_reference_runs_with_the_program_blocked():
    res = _blocked_python(JAX_NAMES | {"snickery_tpu_torch"}, """
        import sys
        import numpy as np
        from benchmark import voices
        from benchmark.reference import compare, search, voice
        utts = [voices.utterances(2, 4, 5, "cpu")]
        v = voice.build(utts, {"mag": 60, "real": 45, "imag": 45, "lf0": 1},
                        ["mag", "real", "imag", "lf0"], [1.0] * 4, [1.0] * 4, "cpu")
        feats = [voices.utterances(1, 4, 6, "cpu")[0]["features"][:20]]
        ans = search.synthesise(v, feats, [0], 5, 0.7, 50)
        nums = compare.numbers(v, [{"unit_ids": ans[0]["unit_ids"], "total_cost": ans[0]["total"],
                                    "wave": ans[0]["wave"]}], feats, [0], [0], 5, 0.7, 50)
        assert nums["cost_gap"] == 0 and nums["id_mismatch"] == 0, nums
        print("PORT", sorted(m for m in sys.modules if m.split(".")[0] == "snickery_tpu_torch"))
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT []" in res.stdout


@pytest.mark.parametrize("name", ["jax.numpy", "snickery_tpu.synth", "flax", "jaxlib"])
def test_forbidden_names_are_compared_whole(monkeypatch, name):
    from benchmark import run
    monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "snickery_tpu_torch_like", object())
    assert run.forbidden_modules() == [name]
