"""The port's binding to the native host library against the port's GF tables.

The module builds the port's copy of the library while it is collected and
skips itself when that build fails (no g++, or a g++ error), as
tests/test_native.py skips when the JAX package's build fails.
"""

import subprocess

import numpy as np
import pytest

from nbldpc_tpu_torch import native
from nbldpc_tpu_torch.gf import get_field

try:
    native.build()
except (OSError, subprocess.CalledProcessError) as exc:
    pytest.skip(f"native library unavailable: {exc}", allow_module_level=True)


@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_gf_tables_match_port(q):
    gf = get_field(q)
    exp, log, inv, mul = native.gf_tables(q)
    np.testing.assert_array_equal(exp, gf.exp)
    np.testing.assert_array_equal(log, gf.log)
    np.testing.assert_array_equal(inv, gf.inv)
    np.testing.assert_array_equal(mul, gf.mul)


def test_build_is_idempotent():
    before = native.LIBRARY.stat().st_mtime_ns
    assert native.build() == native.LIBRARY
    assert native.LIBRARY.stat().st_mtime_ns == before


def test_gf_tables_reject_bad_q():
    with pytest.raises(ValueError, match="q=12"):
        native.gf_tables(12)
