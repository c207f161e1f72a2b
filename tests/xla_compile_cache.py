"""A persistent XLA compile cache for the port's test files, one per test
process, on only while a port file's tests run.

skinjax's references run its Pallas kernels in interpret mode, which executes
a kernel's body one operation at a time and compiles the same small programs
again on every call, and the port's tests call them again and again at the
same shapes. With the cache, a program compiled once in the process is read
back instead. Numbers do not change: a cached executable is the one the
compiler built. The cache lives in a temporary directory that is removed when
the process ends; the files that import ``xla_compile_cache`` switch it on
for their own tests and off after them, so no other test file runs with it.

Import the fixture into a test module to use it::

    from tests.xla_compile_cache import xla_compile_cache  # noqa: F401
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
    compiled) for this module's tests, then off again."""
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    compilation_cache.set_cache_dir(_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    compilation_cache.reset_cache()
    yield
    compilation_cache.set_cache_dir(None)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    compilation_cache.reset_cache()
