"""Pytest session isolation for the repository's whole suite.

Each test session runs under a temporary directory of its own: the
first process of the session (the xdist controller, or the only
process) makes a fresh directory, points ``TMPDIR`` at it, and removes
it when it exits; xdist workers and every subprocess the tests start
inherit it. State that an earlier run left in the system temp dir then
cannot reach this one.

The case that needs it: ``bench.py`` keeps its warm-start compile cache
in ``<tempdir>/sparkdl-tpu-bench-compile-cache-<uid>``. Once an earlier
session has written entries there, the bench tests of the next session
deserialize them and the executables fail at launch under this jax
("Expected args to execute_sharded_on_local_devices to have 8 shards"),
so the suite passes only on a host where it never ran before.

This is a stopgap for that defect of ``bench.py``'s cache key, which is
not fixed yet. It sets ``TMPDIR`` (and the marker variable below) and
nothing else: no option, fixture or marker of any test changes. Remove
it once ``bench.py`` keys its cache on whatever differs between runs.
"""

import atexit
import os
import shutil
import tempfile

_SESSION_ENV = "SPARKDL_TEST_SESSION_TMPDIR"

if _SESSION_ENV not in os.environ:
    _session_tmp = tempfile.mkdtemp(prefix="sparkdl-tests-")
    os.environ[_SESSION_ENV] = _session_tmp
    os.environ["TMPDIR"] = _session_tmp
    tempfile.tempdir = None  # the next gettempdir() reads TMPDIR again
    atexit.register(shutil.rmtree, _session_tmp, ignore_errors=True)
