"""Build the native library (native/libpoca_native.so) once per test run,
before any test module decides on it.

tests/test_native.py decides its skips when it is imported, through a
first-use `make` in cpppathtracer_tpu/utils/native.py that only a thread
lock guards.  Under pytest-xdist every worker imports that module, so on a
fresh tree one worker could load the library while another was still
writing it, and skip the native tests.  Here the controller and each
worker take an fcntl lock on native/.build.lock and build only when the
library is absent, checking again under the lock; the library is written
to a temporary name and renamed into place, so it is either whole or
absent.  A failed build leaves it absent, and the native tests skip as
they did before.  This file imports neither package.
"""

import fcntl
import os
import subprocess
from pathlib import Path

NATIVE = Path(__file__).resolve().parent / "native"
LIB = NATIVE / "libpoca_native.so"


def pytest_configure(config):
    if LIB.exists() or not (NATIVE / "Makefile").exists():
        return
    with open(NATIVE / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if LIB.exists():
            return
        tmp = f"{LIB.name}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", str(NATIVE), f"TARGET={tmp}"], check=True,
                           capture_output=True, timeout=120)
            os.replace(NATIVE / tmp, LIB)
        except (OSError, subprocess.SubprocessError):
            pass
        finally:
            (NATIVE / tmp).unlink(missing_ok=True)
