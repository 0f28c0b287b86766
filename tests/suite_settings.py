"""Settings of a test run that ``conftest.py`` does not hold, loaded as a
pytest plugin (``pyproject.toml``: ``addopts = "-p suite_settings"``).

- Every test phase (setup, call, teardown) has a time limit: ``TIMEOUT_S``,
  or the seconds of the test's ``timeout`` marker.  SIGALRM fails the phase;
  a wait inside native code that the signal cannot interrupt gets its stacks
  dumped and the process ended a minute later.  The longest phase measured,
  with six workers on eight cores, took 124 s.
- Each xdist worker gets an equal share of the cores for its thread pools.
- The JAX compile cache lives under the run's own temporary directory.

It imports neither JAX nor torch, so it also loads where they are absent.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import tempfile

import pytest

TIMEOUT_S = 300

# The backstop writes to the stderr the process started with: output capture
# swaps sys.stderr for objects without a descriptor and redirects fd 2 to a
# file that a process ended by the backstop never shows.
_STDERR_FD = os.dup(2)


def pytest_configure(config):
    # numpy's OpenBLAS busy-waits: six workers each holding a pool of every
    # core ran the eager parity tests ~50x slower than one alone.  A worker's
    # pools are sized when it imports numpy, before any plugin runs, so the
    # controller sets them for the workers it starts.
    workers = getattr(config.option, "numprocesses", None)
    if workers and not hasattr(config, "workerinput"):
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(var, str(max(1, cores // workers)))

    # conftest.py points the persistent cache at a fixed path; two runs side
    # by side, each with its own TMPDIR, would then warm each other's.  No
    # compile has run yet, so the cache is not yet opened.
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update(
            "jax_compilation_cache_dir",
            os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(tempfile.gettempdir(), "jax_cache_tests"))


@contextlib.contextmanager
def _time_limit(item, phase):
    marker = item.get_closest_marker("timeout")
    limit = marker.args[0] if marker else TIMEOUT_S

    def expire(signum, frame):
        pytest.fail(f"{phase} exceeded the time limit of {limit} s", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + 60, exit=True, file=_STDERR_FD)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "teardown"):
        return (yield)
