"""The JAX package's native epoch detector as a parity reference that cannot
quietly become the Python detector.

``snickery_tpu.native`` builds ``native/libsnickery_native.so`` in place with
``make`` when no library is found, and caches a failed load for the life of
the process.  Several test processes starting that build at once can load a
half-written file; the loser then runs the Python detector under
``detect_epochs(use_native=True)``, and a comparison of native marks would
compare against it.  Here the library is built from ``native/epochs.cpp``
with ``native/Makefile``'s compiler and flags into pytest's temporary
directory (a temporary name, then ``os.replace``), ``SNICKERY_NATIVE_LIB``
points the JAX loader at it, the loader's cache is reset, and the load is
asserted: the reference is native or the test errors.

Use the module-scoped fixture :func:`jax_native` (import it into a test
module), or :func:`native_reference` around code of your own.
"""

from __future__ import annotations

import contextlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "native"


def make_flags() -> tuple[str, list[str]]:
    """``CXX`` and ``CXXFLAGS`` as ``native/Makefile`` sets them."""
    text = (NATIVE / "Makefile").read_text()
    cxx = re.search(r"^CXX\s*\?=\s*(.+)$", text, re.M).group(1).strip()
    flags = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", text, re.M).group(1).split()
    return cxx, flags


def build_private_lib(directory: Path) -> Path:
    """``directory/libsnickery_native.so`` from ``native/epochs.cpp``, built
    once (to a temporary name, then renamed into place)."""
    path = Path(directory) / "libsnickery_native.so"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    cxx, flags = make_flags()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    res = subprocess.run([cxx, *flags, "-shared", "-o", tmp, str(NATIVE / "epochs.cpp")],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the JAX package's native detector failed:\n"
                           f"{res.stderr[-2000:]}")
    os.replace(tmp, path)
    return path


@contextlib.contextmanager
def native_reference(lib_path: Path):
    """The JAX loader on ``lib_path`` for the duration: the environment
    override set, ``_lib`` / ``_lib_failed`` reset (whatever the process
    cached before) and restored afterwards; yields the loaded library, and
    asserts on entry and on exit that the loader holds it."""
    from snickery_tpu import native as jnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SNICKERY_NATIVE_LIB", str(lib_path))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_lib_failed", False)
        lib = jnative.get_lib()
        assert lib is not None and lib._name == str(lib_path), (
            f"the JAX package's loader did not load {lib_path}: the reference would be "
            f"the Python detector")
        yield lib
        assert jnative.get_lib() is lib and not jnative._lib_failed, (
            "the JAX package's native library was unloaded while in use")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native detector, loaded from a private build, for
    the tests of one module."""
    lib_path = build_private_lib(tmp_path_factory.getbasetemp() / "jaxnative")
    with native_reference(lib_path) as lib:
        yield lib
