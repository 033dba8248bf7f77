"""The port's q-last decode path (batch_last=False: common.decode, the q-last
graph methods and check-node updates) against the JAX package, the numpy
oracle and the port's own batch-last path. Inputs are made with numpy from
a seed and go to both packages; the JAX side runs eagerly or under jax.jit
as tests/test_golden.py runs it.

Measured differences from JAX on the CPU: the WHT, the graph methods, the
EMS and T-EMS check nodes 0 (max, select, gather and one add an element);
the QSPA check node at most 4.4e-5 on outputs up to 8.4 in magnitude (its
sums run in the batch-last plain version's association, not XLA's), held
at rtol 1e-5 and atol 1e-5, the batch-last plain version's tolerance in
tests/test_torch_qspa.py. The decodes equal JAX's frame for frame."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
import nbldpc_tpu.sim as jsim
from nbldpc_tpu.code import CodeSpec as JaxCodeSpec
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import common as jcommon
from nbldpc_tpu.decoders import ems as jems
from nbldpc_tpu.decoders import qspa as jqspa
from nbldpc_tpu.decoders import tems as jtems
from nbldpc_tpu.kernels import wht as jwht
from nbldpc_tpu.utils.config import DecoderConfig as JaxDecoderConfig

from nbldpc_tpu_torch import graph as tgraph
from nbldpc_tpu_torch import sim
from nbldpc_tpu_torch.decoders import common, ems, qspa, tems
from nbldpc_tpu_torch.kernels import wht
from nbldpc_tpu_torch.utils.config import DecoderConfig

from tests.reference_model import OracleDecoder
from tests.test_torch_qspa import noisy_llrs, port_graph

torch.set_num_threads(1)

QSPA_TOL = 1e-5


def mixed_spec(q: int = 16) -> JaxCodeSpec:
    """A hand-built code with variables of degree 1, 2 and 3 (VN pad slots)
    and checks of degree 3 to 5 (CN pad slots), weights from a seed."""
    rows = [(0, 1, 2, 6), (1, 3, 4), (0, 2, 5, 7, 9), (3, 6, 8, 10),
            (4, 5, 9, 11), (0, 7, 8, 11)]
    rng = np.random.default_rng(q)
    return JaxCodeSpec(q, 12, len(rows), tuple(np.array(r, np.int32) for r in rows),
                       tuple(rng.integers(1, q, size=len(r)).astype(np.int32) for r in rows))


@pytest.fixture(scope="module")
def codes(small_codes):
    return {**small_codes, "mixed": mixed_spec(),
            "gf64": make_peg_code(12, 6, 64, dv=2, seed=5),
            "gf256": make_peg_code(12, 6, 256, dv=2, seed=5)}


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))            # a writable copy


def _normal(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


@pytest.mark.parametrize("q", [2, 4, 8, 16, 32, 64, 128, 256])
def test_wht_matches_jax_and_matrix(q):
    x = np.random.default_rng(q).standard_normal((3, 5, q)).astype(np.float32)
    got = wht.wht(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jwht.wht(jnp.asarray(x))))
    np.testing.assert_allclose(got, x.astype(np.float64) @ wht.wht_matrix(q).T,
                               rtol=1e-5, atol=1e-4)
    inv = wht.iwht(_t(got)).numpy()
    np.testing.assert_array_equal(inv, np.asarray(jwht.iwht(jnp.asarray(got))))
    np.testing.assert_allclose(inv, x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("code", ["gf16_irr", "mixed"])
def test_graph_methods_match_jax(codes, code):
    spec = codes[code]
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    assert tg.has_cn_pads and tg.has_vn_pads == (code == "mixed")
    rng = np.random.default_rng(7)
    B, q = 3, tg.q
    Cm = _normal(rng, (B, tg.m, tg.dc_max, q))                 # CN-major
    Vv = _normal(rng, (B, tg.n, tg.dv_max, q))                 # VN-major
    for name, x in (("gather_vn", Cm), ("gather_cn", Vv), ("gather_cn_x", Vv),
                    ("gather_vn_x", Cm), ("permute_down", Cm), ("permute_up", Cm)):
        np.testing.assert_array_equal(getattr(tg, name)(_t(x)).numpy(),
                                      np.asarray(getattr(jg, name)(jnp.asarray(x))),
                                      err_msg=name)
    hard = rng.integers(0, q, size=(5, tg.n)).astype(np.int32)
    hard[0] = 0                                                # a codeword
    got = tg.syndrome(_t(hard)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.syndrome(jnp.asarray(hard))))
    assert got.shape == (5, tg.m) and not got[0].any()
    x = rng.integers(0, 1 << 20, size=(4, 6, 3)).astype(np.int32)
    for dim in (0, 1, -1):
        np.testing.assert_array_equal(tgraph.xor_reduce(_t(x), dim).numpy(),
                                      np.asarray(jgraph.jax_xor_reduce(jnp.asarray(x), dim)))


def _u(jg, B: int, seed: int) -> np.ndarray:
    """q-last x-domain CN inputs with the real pad structure (JAX gather)."""
    Vv = _normal(np.random.default_rng(seed), (B, jg.n, jg.dv_max, jg.q))
    return np.asarray(jax.jit(jg.gather_cn_x)(jnp.asarray(Vv)))


# (id, code, the JAX update, the port's, tolerance)
CN_CASES = [
    ("qspa_gf4", "gf4_tiny", jqspa.qspa_cn_update, qspa.qspa_cn_update, QSPA_TOL),
    ("qspa_gf16_irr", "gf16_irr", jqspa.qspa_cn_update, qspa.qspa_cn_update, QSPA_TOL),
    ("qspa_mixed", "mixed", jqspa.qspa_cn_update, qspa.qspa_cn_update, QSPA_TOL),
    *((f"ems_{code}_nm{nm}", code,
       lambda U, g, nm=nm: jems.ems_cn_update(U, g, nm=nm, offset=0.3),
       lambda U, g, nm=nm: ems.ems_cn_update(U, g, nm=nm, offset=0.3), 0.0)
      for code, nm in (("mixed", 8), ("gf16_tiny", 16), ("gf64", 8), ("gf256", 16))),
    *((f"tems_{code}_nr{n_r}", code,
       lambda U, g, n_r=n_r: jtems.tems_cn_update(U, g, offset=0.5, n_r=n_r),
       lambda U, g, n_r=n_r: tems.tems_cn_update(U, g, offset=0.5, n_r=n_r), 0.0)
      for code, n_r in (("mixed", 0), ("gf16_tiny", 8), ("gf64", 8))),
]


@pytest.mark.parametrize("case", CN_CASES, ids=[c[0] for c in CN_CASES])
def test_cn_update_matches_jax(codes, case):
    _, code, jfn, tfn, tol = case
    spec = codes[code]
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    U = _u(jg, 4, seed=spec.q)
    want = np.asarray(jax.jit(lambda u: jfn(u, jg))(jnp.asarray(U)))
    got = tfn(_t(U), tg).numpy()
    assert not got[:, ~tg.np["cn_mask"]].any()               # pad outputs are 0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# one iteration's check->variable messages (c-domain) against the oracle
ORACLE_CASES = [
    ("qspa_gf4", "gf4_tiny", dict(kind="qspa"), qspa.qspa_cn_update),
    ("qspa_gf16", "gf16_tiny", dict(kind="qspa"), qspa.qspa_cn_update),
    *((f"ems_nm{nm}", "gf16_tiny", dict(kind="ems", nm=nm),
       lambda U, g, nm=nm: ems.ems_cn_update(U, g, nm=nm)) for nm in (4, 8, 16)),
    ("tems", "gf16_tiny", dict(kind="tems"), tems.tems_cn_update),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_messages_one_iter_match_oracle(codes, case):
    _, code, okw, cn = case
    spec = codes[code]
    _, llr = noisy_llrs(spec, 3, 2.0, seed=1)
    g = port_graph(spec)
    L = _t(llr)
    L = L - L.amax(dim=-1, keepdim=True)
    C0 = torch.zeros((L.shape[0], g.m, g.dc_max, g.q))
    U, _, _ = common.vn_update(g, L, C0)
    C1 = g.permute_up(cn(U, g)).numpy()
    oracle = OracleDecoder(spec, **okw)
    for b in range(llr.shape[0]):
        _, _, _, C_o = oracle.decode(llr[b], max_iters=1, early_term=False,
                                     return_messages=True)
        for mi in range(spec.m):
            for j in range(len(spec.row_cols[mi])):
                np.testing.assert_allclose(C1[b, mi, j], C_o[mi][j], rtol=2e-3, atol=2e-3,
                                           err_msg=f"frame {b} check {mi} slot {j}")


def test_vn_update_matches_jax(codes):
    spec = codes["mixed"]
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    rng = np.random.default_rng(3)
    llr = _normal(rng, (4, tg.n, tg.q))
    C = _normal(rng, (4, tg.m, tg.dc_max, tg.q))
    want = jax.jit(lambda l, c: jcommon.vn_update(jg, l, c))(jnp.asarray(llr), jnp.asarray(C))
    for got, ref in zip(common.vn_update(tg, _t(llr), _t(C)), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# (id, code, frames, Eb/N0, iterations, the JAX decode, the port's keywords);
# GF(256) EMS (a JAX compile of ~17 s a mode) is held through its check node
# above and the port's batch-last path below
DECODE_CASES = [
    *((f"qspa_{code}", code, 16, 2.0, 8, jqspa.decode, dict())
      for code in ("gf16_irr", "gf4_dv3", "mixed")),
    ("ems_mixed_nm8", "mixed", 16, 2.5, 6, jems.decode, dict(nm=8, offset=0.2)),
    ("ems_gf64_nm8", "gf64", 4, 4.0, 4, jems.decode, dict(nm=8)),
    ("tems_mixed", "mixed", 12, 2.5, 6, jtems.decode, dict(offset=0.5)),
    ("tems_gf16_nr8", "gf16_tiny", 12, 2.5, 6, jtems.decode, dict(n_r=8)),
]
PORT_DECODE = {jqspa.decode: qspa.decode, jems.decode: ems.decode, jtems.decode: tems.decode}


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_q_last_matches_jax(codes, case, early_term):
    _, code, frames, ebn0, iters, jdecode, kw = case
    spec = codes[code]
    _, llr = noisy_llrs(spec, frames, ebn0, seed=2)
    ref = jdecode(jgraph.TannerGraph(spec), jnp.asarray(llr), iters, early_term=early_term,
                  batch_last=False, **kw)
    res = PORT_DECODE[jdecode](port_graph(spec), _t(llr), iters, early_term=early_term,
                               batch_last=False, **kw)
    for name in ("hard", "done", "iters"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert res.hard.dtype == torch.int32 and res.iters.dtype == torch.int32


# JAX's layout tests' codes and decoders (tests/test_golden.py::
# test_qspa_layouts_agree, tests/test_golden_ems_tems.py::
# test_*_batch_last_matches_q_last), plus the pad structures and n_r
LAYOUT_CASES = [
    *((f"qspa_{code}", code, qspa.decode, dict()) for code in
      ("gf4_tiny", "gf16_tiny", "gf4_n96", "gf4_dv3", "gf16_irr", "mixed")),
    *((f"ems_{code}_nm{nm}", code, ems.decode, dict(nm=nm)) for code, nm in
      (("gf16_tiny", 8), ("gf64", 8), ("gf256", 16), ("mixed", 4))),
    *((f"tems_{code}_nr{n_r}", code, tems.decode, dict(n_r=n_r)) for code, n_r in
      (("gf16_tiny", 0), ("gf16_tiny", 8), ("mixed", 0))),
]


@pytest.mark.parametrize("mode", [dict(early_term=True), dict(early_term=False)],
                         ids=["early_term", "fixed"])
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_q_last_matches_batch_last(codes, case, mode):
    """The port's two layouts give the same hard/done/iters frame for frame
    (decode_bl with its per-iteration decisions, stats_each_iter=True)."""
    _, code, decode, kw = case
    spec = codes[code]
    _, llr = noisy_llrs(spec, 16, 2.0, seed=7)
    g, L = port_graph(spec), _t(llr)
    ql = decode(g, L, 8, batch_last=False, **mode, **kw)
    bl = decode(g, L, 8, cn_impl="torch", **mode, **kw)
    for name, a, b in zip(("hard", "done", "iters"), ql, bl):
        assert torch.equal(a, b), name


def test_refusals(codes):
    g = port_graph(codes["gf16_tiny"])
    llr = torch.zeros((2, g.n, g.q))
    for cn_impl in ("resident", "kernel"):
        with pytest.raises(ValueError, match="q-last"):
            qspa.decode(g, llr, cn_impl=cn_impl, batch_last=False)
        with pytest.raises(ValueError, match="q-last"):
            ems.decode(g, llr, cn_impl=cn_impl, batch_last=False)
    with pytest.raises(ValueError, match="q-last"):
        qspa.decode(g, llr, mm_precision="bf16", batch_last=False)
    with pytest.raises(ValueError, match="q-last"):
        ems.decode(g, llr, merge="bubble", batch_last=False)
    with pytest.raises(ValueError, match="q-last"):
        tems.decode(g, llr, cn_impl="kernel", batch_last=False)
    # what the path can give runs, stats_each_iter accepted and ignored
    for decode in (qspa.decode, ems.decode, tems.decode):
        for cn_impl in ("auto", "torch"):
            a = decode(g, llr, 2, cn_impl=cn_impl, stats_each_iter=False, batch_last=False)
            assert a.hard.shape == (2, g.n) and a.hard.device == llr.device


@pytest.mark.parametrize("kind,kw", [("qspa", {}), ("ems", dict(nm=4, offset=0.3)),
                                     ("tems", dict(offset=0.5, tems_nr=8))])
def test_get_cn_update_matches_jax(codes, kind, kw):
    spec = codes["gf16_irr"]
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    U = _u(jg, 3, seed=11)
    jfn = jsim.get_cn_update(JaxDecoderConfig(kind=kind, **kw))
    want = np.asarray(jax.jit(lambda u: jfn(u, jg))(jnp.asarray(U)))
    tfn = sim.get_cn_update(DecoderConfig(kind=kind, **kw))
    np.testing.assert_allclose(tfn(_t(U), tg).numpy(), want, rtol=QSPA_TOL, atol=QSPA_TOL)
    if kind == "tems":        # JAX's entry passes no n_r: the exact scan
        np.testing.assert_array_equal(tfn(_t(U), tg).numpy(),
                                      tems.tems_cn_update(_t(U), tg, offset=0.5).numpy())
    with pytest.raises(ValueError):
        sim.get_cn_update(types.SimpleNamespace(kind="bp"))
