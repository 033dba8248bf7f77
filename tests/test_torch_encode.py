"""The port's GF(q) row reduction and systematic encoder against the JAX
package's, on the same numpy inputs: the native row reduction against its
numpy plain version and both against JAX's, the encoder's tables and
codewords bit for bit, H c = 0 by three independent checks."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.code as jcode
from nbldpc_tpu.encode import Encoder as JaxEncoder
from nbldpc_tpu.encode import gf_row_reduce as jax_row_reduce
from nbldpc_tpu.gf import get_field as jax_field

from nbldpc_tpu_torch import native
from nbldpc_tpu_torch.code import CodeSpec, load_alist
from nbldpc_tpu_torch.encode import Encoder, gf_row_reduce, gf_row_reduce_plain
from nbldpc_tpu_torch.gf import get_field

from tests.test_torch_qspa import port_graph

torch.set_num_threads(1)

CODES = Path(__file__).resolve().parents[1] / "codes"
ALISTS = sorted(p.stem for p in CODES.glob("*.alist"))
SMALL = ["gf4_tiny", "gf16_tiny", "gf4_n96", "gf16_irr", "gf4_dv3"]


def _specs(small_codes, name):
    """(JAX spec, port spec) of a conftest code or a codes/ file."""
    if name in small_codes:
        js = small_codes[name]
        return js, port_graph(js).spec
    path = CODES / f"{name}.alist"
    return jcode.load_alist(path), load_alist(path)


@pytest.mark.parametrize("name", SMALL + ALISTS)
def test_row_reduce_native_plain_and_jax_agree(small_codes, name):
    js, ts = _specs(small_codes, name)
    H = ts.dense_h()
    gf = get_field(ts.q)
    R, rank, piv = gf_row_reduce(H, gf)
    for R2, rank2, piv2 in (gf_row_reduce_plain(H, gf),
                            jax_row_reduce(js.dense_h(), jax_field(js.q))):
        assert rank2 == rank
        np.testing.assert_array_equal(R2, R)
        np.testing.assert_array_equal(piv2, piv)
    assert R.dtype == np.int32 and piv.dtype == np.int32
    np.testing.assert_array_equal(R[np.arange(rank), piv], np.ones(rank, np.int32))


@pytest.mark.parametrize("q", [2, 16, 256])
def test_row_reduce_random_matrices(q):
    """Dense random matrices, wider and taller than square, with zero
    columns and repeated rows: native, plain and JAX agree."""
    rng = np.random.default_rng(q)
    gf = get_field(q)
    for shape in ((7, 19), (19, 7), (12, 12)):
        H = rng.integers(0, q, size=shape).astype(np.int32)
        H[:, 3] = 0
        H[-1] = H[0]
        R, rank, piv = gf_row_reduce(H, gf)
        R2, rank2, piv2 = gf_row_reduce_plain(H, gf)
        R3, rank3, piv3 = jax_row_reduce(H, jax_field(q))
        assert rank == rank2 == rank3 <= min(shape) - 1
        for a, b in ((R, R2), (R, R3), (piv, piv2), (piv, piv3)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", SMALL + ALISTS)
def test_encoder_matches_jax(small_codes, name):
    js, ts = _specs(small_codes, name)
    je, te = JaxEncoder(js), Encoder(ts, "cpu")
    assert te.k == je.k == ts.n - ts.m
    np.testing.assert_array_equal(te.P, je.P)
    np.testing.assert_array_equal(te.info_cols, je.info_cols)
    np.testing.assert_array_equal(te.piv_cols, je.piv_cols)

    rng = np.random.default_rng(ts.n + ts.q)
    u = rng.integers(0, ts.q, size=(3, 7, te.k)).astype(np.int32)
    cw = te.encode(torch.from_numpy(u))
    assert cw.dtype == torch.int32 and cw.shape == (3, 7, ts.n)
    np.testing.assert_array_equal(cw.numpy(), np.asarray(je.encode(jnp.asarray(u))))
    # systematic: the info symbols stand in info_cols, in order
    np.testing.assert_array_equal(cw.numpy()[..., te.info_cols], u)


@pytest.mark.parametrize("name", ["gf16_irr", "gf4_dv3", *ALISTS])
def test_codewords_satisfy_h(small_codes, name):
    """H c = 0 through gf.matvec (numpy) and native.syndrome (C++), and
    through the graph's syndrome_bl; a codeword with one symbol changed
    fails all three."""
    _, ts = _specs(small_codes, name)
    te, gf = Encoder(ts, "cpu"), get_field(ts.q)
    u = np.random.default_rng(1).integers(0, ts.q, size=(5, te.k)).astype(np.int32)
    cw = te.encode(torch.from_numpy(u)).numpy()
    H = ts.dense_h()
    bad = cw.copy()
    bad[:, 0] ^= 1
    for words, ok in ((cw, True), (bad, False)):
        syn_np = np.stack([gf.matvec(H, c) for c in words])
        syn_c = native.syndrome(ts.q, ts.n, ts.row_cols, ts.row_vals, gf.mul, words)
        np.testing.assert_array_equal(syn_c, syn_np)
        syn_bl = port_graph(ts).syndrome_bl(torch.from_numpy(words.T.copy())).numpy().T
        np.testing.assert_array_equal(syn_bl, syn_np)
        assert (not syn_np.any()) == ok and bool(syn_np.any(axis=1).all()) != ok


def test_rank_deficient_h_raises():
    # row 2 = row 0 + row 1 over GF(4): rank 2 < 3
    H = np.array([[1, 2, 0, 3, 0], [0, 1, 1, 0, 2], [1, 3, 1, 3, 2]], np.int32)
    spec = CodeSpec.from_dense(H, 4)
    assert gf_row_reduce(H, get_field(4))[1] == 2
    with pytest.raises(ValueError, match="rank-deficient"):
        Encoder(spec, "cpu")
    with pytest.raises(ValueError, match="rank-deficient"):
        JaxEncoder(jcode.CodeSpec.from_dense(H, 4))


def test_from_dense_matches_jax(small_codes):
    H = small_codes["gf16_irr"].dense_h()
    a, b = CodeSpec.from_dense(H, 16), jcode.CodeSpec.from_dense(H, 16)
    assert (a.q, a.n, a.m) == (b.q, b.n, b.m)
    for x, y in zip(a.row_cols + a.row_vals, b.row_cols + b.row_vals):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.int32


@pytest.mark.parametrize("q", [2, 4, 16, 64, 256])
def test_gf_host_ops_match_jax(q):
    gf, jf = get_field(q), jax_field(q)
    rng = np.random.default_rng(q)
    a, b = rng.integers(0, q, size=(2, 50))
    nz = rng.integers(1, q, size=50)
    np.testing.assert_array_equal(gf.gmul(a, b), jf.gmul(a, b))
    np.testing.assert_array_equal(gf.gdiv(a, nz), jf.gdiv(a, nz))
    np.testing.assert_array_equal(gf.ginv(a), jf.ginv(a))
    np.testing.assert_array_equal(gf.gmul(gf.gdiv(a, nz), nz), a)
    A, B = rng.integers(0, q, size=(4, 6)), rng.integers(0, q, size=(6, 3))
    np.testing.assert_array_equal(gf.matmul(A, B), jf.matmul(A, B))
    np.testing.assert_array_equal(gf.matvec(A, B[:, 0]), jf.matvec(A, B[:, 0]))


def test_native_wrappers_reject_bad_input():
    gf = get_field(4)
    with pytest.raises(ValueError, match="outside GF"):
        native.gf_row_reduce(np.array([[1, 4]]), 4, gf.mul, gf.inv)
    with pytest.raises(ValueError, match="mul: shape"):
        native.gf_row_reduce(np.array([[1, 2]]), 4, gf.mul[:2], gf.inv)
    with pytest.raises(ValueError, match="cw must be"):
        native.syndrome(4, 3, (np.array([0, 1]),), (np.array([1, 2]),), gf.mul,
                        np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="variable"):
        native.peg_bfs([0, 0], [], [0, 0], [], 1, 1, 1)
    with pytest.raises(ValueError, match="CSR"):
        native.peg_bfs([0, 2], [0], [0, 1], [0], 1, 1, 0)
