"""Repository-wide pytest hook: build the native host library once, before
any test module is collected.

`nbldpc_tpu/native.py` builds build/libnbldpc_host.so on first use, with
no lock, and `tests/test_native.py` decides while it is collected whether
to skip. Under pytest-xdist every worker collects that module at once, so
on a fresh checkout the workers race to write one file and may all skip.
`pytest_configure` runs in the controller before any worker starts (and
again in each worker, where it finds the library fresh): it builds the
library under an exclusive lock, only when it is missing or older than its
source, into a file of its own process that is renamed into place. A
failed build is silent; the tests that need the library then skip as
before. Stdlib only: this hook imports neither JAX nor torch.
"""

import fcntl
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "native" / "nbldpc_host.cpp"
BUILD_DIR = ROOT / "build"
LIBRARY = BUILD_DIR / "libnbldpc_host.so"
# the flags of nbldpc_tpu/native.py
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _fresh() -> bool:
    return LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime


def build_host_library() -> None:
    if _fresh():
        return
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "libnbldpc_host.build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return
        tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, LIBRARY)
        except (OSError, subprocess.SubprocessError):
            pass
        finally:
            tmp.unlink(missing_ok=True)


def pytest_configure(config):
    build_host_library()
