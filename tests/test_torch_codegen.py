"""The port's code generator against the JAX package's and the checked-in
codes: PEG and quasi-cyclic codes bit for bit for the seeds the tests use,
every standard code equal to its codes/ file, the native BFS equal to the
numpy BFS, and `gen-codes --out` reproducing codes/ byte for byte."""

from pathlib import Path

import numpy as np
import pytest

import nbldpc_tpu.codegen as jcodegen

from nbldpc_tpu_torch import cli, codegen
from nbldpc_tpu_torch.code import load_alist

ROOT = Path(__file__).resolve().parents[1]


def _assert_same_spec(a, b):
    assert (a.q, a.n, a.m) == (b.q, b.n, b.m)
    for x, y in zip(a.row_cols + a.row_vals, b.row_cols + b.row_vals):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.int32


# the conftest codes (n, m, q, dv, seed) and chunk8 twins of two of them
PEG_CASES = [((12, 6, 4, 2, 7), "random"), ((16, 8, 16, 2, 7), "random"),
             ((96, 48, 4, 2, 1), "random"), ((18, 8, 16, 2, 5), "random"),
             ((24, 12, 4, 3, 5), "random"), ((16, 8, 4, 2, 5), "random"),
             ((12, 6, 64, 2, 3), "random"), ((12, 6, 256, 2, 3), "random"),
             ((96, 48, 4, 2, 1), "chunk8"), ((40, 20, 16, 2, 3), "chunk8")]


@pytest.mark.parametrize("args,mode", PEG_CASES)
def test_make_peg_code_matches_jax(args, mode):
    n, m, q, dv, seed = args
    _assert_same_spec(codegen.make_peg_code(n, m, q, dv=dv, seed=seed, weight_mode=mode),
                      jcodegen.make_peg_code(n, m, q, dv=dv, seed=seed, weight_mode=mode))


@pytest.mark.parametrize("args", [(96, 48, 4, 8, 2, 1, "circulant"),
                                  (48, 24, 16, 8, 2, 3, "circulant"),
                                  (204, 102, 16, 34, 2, 1, "slot"),
                                  (64, 32, 64, 8, 3, 2, "slot")])
def test_make_qc_code_matches_jax(args):
    n, m, q, z, dv, seed, mode = args
    _assert_same_spec(codegen.make_qc_code(n, m, q, z, dv=dv, seed=seed, weight_mode=mode),
                      jcodegen.make_qc_code(n, m, q, z, dv=dv, seed=seed, weight_mode=mode))


def test_qc_code_refusals():
    with pytest.raises(ValueError, match="must divide"):
        codegen.make_qc_code(30, 12, 4, 8)
    with pytest.raises(ValueError, match="at least dv"):
        codegen.make_qc_code(16, 8, 4, 8, dv=2)


@pytest.mark.parametrize("name", codegen.standard_names())
def test_build_standard_code_equals_checked_in_alist(name):
    spec = codegen.build_standard_code(name)
    _assert_same_spec(spec, load_alist(ROOT / "codes" / f"{name}.alist"))


def test_standard_tables_match_jax():
    assert codegen.STANDARD_CODES == jcodegen.STANDARD_CODES
    assert codegen.STANDARD_CODES_QC == jcodegen.STANDARD_CODES_QC
    assert codegen.STANDARD_CODES_C8 == jcodegen.STANDARD_CODES_C8
    assert sorted(codegen.standard_names()) == sorted(p.stem for p in (ROOT / "codes").glob("*.alist"))
    with pytest.raises(KeyError):
        codegen.build_standard_code("no_such_code")


@pytest.mark.parametrize("n,m,edges,seed", [(30, 12, 0, 1), (30, 12, 25, 2), (60, 30, 120, 3),
                                            (8, 40, 16, 4)])
def test_native_bfs_equals_numpy_bfs(n, m, edges, seed):
    """Random partial Tanner graphs (unreached checks included): the native
    BFS and the numpy BFS give the same distance from every variable."""
    rng = np.random.default_rng(seed)
    vn_checks, cn_vars = [[] for _ in range(n)], [[] for _ in range(m)]
    for _ in range(edges):
        v, c = int(rng.integers(n)), int(rng.integers(m))
        if c not in vn_checks[v]:
            vn_checks[v].append(c)
            cn_vars[c].append(v)
    for v in range(n):
        a = codegen.bfs_dist(vn_checks, cn_vars, v)
        b = codegen.bfs_dist_plain(vn_checks, cn_vars, v)
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_peg_structure_same_with_either_bfs():
    a, b = (codegen._peg_structure(24, 12, np.full(24, 2), np.random.default_rng(5), bfs=f)
            for f in (codegen.bfs_dist, codegen.bfs_dist_plain))
    assert a == b


def test_gen_codes_writes_codes_byte_for_byte(tmp_path, capsys):
    assert cli.main(["gen-codes", "--out", str(tmp_path)]) == 0
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == sorted(p.name for p in (ROOT / "codes").glob("*.alist"))
    for name in written:
        assert (tmp_path / name).read_bytes() == (ROOT / "codes" / name).read_bytes(), name
    assert capsys.readouterr().out.count("wrote ") == len(written)
