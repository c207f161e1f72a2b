"""A persistent XLA compile cache for the port's test files, one per test
process, and XLA's cheap compile mode, on only while a port file's tests run.

skinjax's references run its Pallas kernels in interpret mode, which executes
a kernel's body one operation at a time and compiles the same small programs
again on every call, and the port's tests call them again and again at the
same shapes. With the cache, a program compiled once in the process is read
back instead. Numbers do not change: a cached executable is the one the
compiler built. The cache lives in a temporary directory that is removed when
the process ends; the files that import ``xla_compile_cache`` switch it on
for their own tests and off after them, so no other test file runs with it.

Most of the port's test time is spent compiling skinjax's references and
train steps (a small tower's jitted train step takes ~10 s to compile and
runs in milliseconds), so the same fixture also compiles with
``jax_disable_most_optimizations`` (XLA's backend optimization level 0):
each program compiles in a fraction of the time and computes the same fp32
or bf16 operations; a sum may be taken in another order, far inside every
tolerance the port's tests state. The flag is read when a program is
compiled, not when a jitted function looks up its cache, so the fixture
clears JAX's caches when the module ends: no executable compiled in the
cheap mode serves a later test file. A test that holds the port to XLA's
optimised numerics bit for bit (a fused multiply-add) takes the
``xla_optimized`` fixture.

Import the fixture into a test module to use it::

    from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

A file whose programs do not repeat (each compiled once, in module-scoped
fixtures) pays for writing every program to the cache and reads none back:
it imports ``xla_cheap_compile`` instead, the cheap mode alone.
"""

import atexit
import shutil
import tempfile

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache

_DIR = []  # the process's cache directory, made on first use


def _cache_dir() -> str:
    if not _DIR:
        _DIR.append(tempfile.mkdtemp(prefix="skinjax-torch-xla-cache-"))
        atexit.register(shutil.rmtree, _DIR[0], ignore_errors=True)
    return _DIR[0]


@pytest.fixture(scope="module", autouse=True)
def xla_compile_cache():
    """The process's compile cache on (every program, however fast it
    compiled) and XLA's cheap compile mode on for this module's tests, then
    both off again."""
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    cheap = jax.config.values["jax_disable_most_optimizations"]
    compilation_cache.set_cache_dir(_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_disable_most_optimizations", True)
    compilation_cache.reset_cache()
    yield
    compilation_cache.set_cache_dir(None)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    jax.config.update("jax_disable_most_optimizations", cheap)
    jax.clear_caches()
    compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def xla_cheap_compile():
    """XLA's cheap compile mode on for this module's tests, without the
    persistent cache, then off again and JAX's caches cleared."""
    cheap = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", cheap)
    jax.clear_caches()


@pytest.fixture
def xla_optimized():
    """XLA's full optimisation for one test, with no executable compiled in
    the cheap mode reused; the cheap mode again after it."""
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", False)
    yield
    jax.config.update("jax_disable_most_optimizations", True)
