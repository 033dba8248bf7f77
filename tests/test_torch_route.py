"""decode_bl's routing (nbldpc_tpu_torch/kernels/route.py) against the JAX
package: route_down_plain against JAX's normalized leave-one-out routed by
graph.gather_cn_x_bl, route_up_plain against llr + the sum of JAX's
graph.gather_vn_x_bl, exactly (the same subtractions, max and adds in the
same association: the measured difference is 0), on codes with CN pad
slots, VN pad slots and dv = 3, at q = 4, 16, 64 and 256 (on a code with
variables of degree up to 10 torch's CPU sum over the slots reassociates
at small batches: within a reassociation bound there); then decode_bl
through the wrappers (route="kernel", which on CPU tensors run the plain
versions) against route="torch" and the decoders against JAX's, and the
decoders' choice of route. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.code import CodeSpec as JaxCodeSpec
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.decoders import ems as jems
from nbldpc_tpu.decoders import qspa as jqspa
from nbldpc_tpu.decoders import tems as jtems

from nbldpc_tpu_torch import convert
from nbldpc_tpu_torch.decoders import common, ems, qspa, tems
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems, route

torch.set_num_threads(1)


def port_graph(spec) -> TannerGraph:
    return TannerGraph(convert.codespec_from_arrays(
        spec.q, spec.n, spec.m, spec.row_cols, spec.row_vals), device="cpu")


def irregular_spec(q: int, seed: int, n: int = 30, m: int = 12) -> JaxCodeSpec:
    """A code over GF(q) with checks of degree 3-5 (CN pad slots) and
    variables of degree 1 to 4 (VN pad slots), random nonzero weights."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(n, size=int(rng.integers(3, 6)), replace=False))
            for _ in range(m)]
    for v in sorted(set(range(n)) - set(np.concatenate(cols).tolist())):
        i = int(rng.integers(0, m))
        cols[i] = np.sort(np.append(cols[i], v))
    return JaxCodeSpec(q, n, m, tuple(c.astype(np.int32) for c in cols),
                       tuple(rng.integers(1, q, size=len(c)).astype(np.int32) for c in cols))


# name -> a function making its spec (small_codes -> JAX CodeSpec)
CODES = {
    "gf4_tiny": lambda sc: sc["gf4_tiny"],
    "gf16_irr": lambda sc: sc["gf16_irr"],                 # CN pad slots
    "gf4_dv3": lambda sc: sc["gf4_dv3"],                   # dv = 3
    "irr_gf4": lambda sc: irregular_spec(4, 1),            # CN and VN pad slots
    "irr_gf16": lambda sc: irregular_spec(16, 4),
    "irr_gf64": lambda sc: irregular_spec(64, 6),
    "irr_gf256": lambda sc: irregular_spec(256, 2, n=16, m=6),
    "dense_gf16": lambda sc: irregular_spec(16, 9, n=12, m=20),   # dv 2 to 10
    "peg_gf64": lambda sc: make_peg_code(12, 6, 64, dv=2, seed=3),
    "peg_gf256": lambda sc: make_peg_code(12, 6, 256, dv=2, seed=3),
}


def _normal(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


def test_codes_cover_the_pad_structures(small_codes):
    graphs = {name: port_graph(build(small_codes)) for name, build in CODES.items()}
    assert graphs["gf16_irr"].has_cn_pads and not graphs["gf16_irr"].has_vn_pads
    assert all(graphs[c].has_cn_pads and graphs[c].has_vn_pads
               for c in ("irr_gf4", "irr_gf16", "irr_gf64", "irr_gf256"))
    assert graphs["gf4_dv3"].dv_max == 3 and graphs["dense_gf16"].dv_max == 10
    assert {g.q for g in graphs.values()} == {4, 16, 64, 256}


@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("code", list(CODES))
def test_route_down_plain_matches_jax(small_codes, code, B):
    spec = CODES[code](small_codes)
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    rng = np.random.default_rng(B)
    post = _normal(rng, (tg.n, tg.q, B))
    Cv = _normal(rng, (tg.n, tg.dv_max, tg.q, B))
    Cv = np.where(tg.np["vn_mask"][:, :, None, None], Cv, 0.0).astype(np.float32)

    @jax.jit
    def vn_update(posterior, Cv):             # JAX decode_bl's "vn_update" scope
        Vv = posterior[:, None] - Cv
        Vv = Vv - jnp.max(Vv, axis=2, keepdims=True)
        return jg.gather_cn_x_bl(Vv)

    want = np.asarray(vn_update(jnp.asarray(post), jnp.asarray(Cv)))
    calls, launches = route.route_down_plain.calls, route.route_down.launches
    got = route.route_down_plain(torch.from_numpy(post), torch.from_numpy(Cv), tg)
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the wrapper runs the plain version and launches nothing
    np.testing.assert_array_equal(
        route.route_down(torch.from_numpy(post), torch.from_numpy(Cv), tg).numpy(), want)
    assert route.route_down_plain.calls == calls + 2
    assert route.route_down.launches == launches


@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("code", list(CODES))
def test_route_up_plain_matches_jax(small_codes, code, B):
    spec = CODES[code](small_codes)
    jg, tg = jgraph.TannerGraph(spec), port_graph(spec)
    rng = np.random.default_rng(100 + B)
    Chat = _normal(rng, (tg.m, tg.dc_max, tg.q, B))
    llr = _normal(rng, (tg.n, tg.q, B))

    @jax.jit
    def posterior(Chat, llr):                 # JAX decode_bl's "posterior" scope
        Cv = jg.gather_vn_x_bl(Chat)
        return Cv, llr + jnp.sum(Cv, axis=1)

    want = [np.asarray(a) for a in posterior(jnp.asarray(Chat), jnp.asarray(llr))]
    calls, launches = route.route_up_plain.calls, route.route_up.launches
    for fn in (route.route_up_plain, route.route_up):
        Cv, post = fn(torch.from_numpy(Chat), torch.from_numpy(llr), tg)
        np.testing.assert_array_equal(Cv.numpy(), want[0])
        if tg.dv_max <= 6:
            np.testing.assert_array_equal(post.numpy(), want[1])
        else:
            # XLA adds the slots left to right; torch's CPU sum over 10
            # slots takes another association at a small q B (measured:
            # up to 2.9e-6 at B = 1 and 7, 0 at B = 32 and 64). Bound: a
            # reassociated sum of dv_max + 1 terms, (dv_max + 1) eps sum |terms|
            terms = np.abs(llr) + np.abs(want[0]).sum(axis=1)
            bound = (tg.dv_max + 1) * np.finfo(np.float32).eps * terms
            assert (np.abs(post.numpy() - want[1]) <= bound).all()
    assert route.route_up_plain.calls == calls + 2
    assert route.route_up.launches == launches


def test_wrappers_take_empty_batches(small_codes):
    tg = port_graph(small_codes["gf16_irr"])
    U = route.route_down(torch.zeros((tg.n, tg.q, 0)), torch.zeros((tg.n, tg.dv_max, tg.q, 0)),
                         tg)
    Cv, post = route.route_up(torch.zeros((tg.m, tg.dc_max, tg.q, 0)),
                              torch.zeros((tg.n, tg.q, 0)), tg)
    assert U.shape == (tg.m, tg.dc_max, tg.q, 0)
    assert Cv.shape == (tg.n, tg.dv_max, tg.q, 0) and post.shape == (tg.n, tg.q, 0)


def _llrs(spec, frames: int, ebn0: float, seed: int) -> np.ndarray:
    """LLRs [B, N, q] of the all-zero codeword, BPSK over AWGN (numpy)."""
    p = int(spec.q).bit_length() - 1
    bits = ((np.arange(spec.q)[:, None] >> np.arange(p)[None, :]) & 1).astype(np.float32)
    sigma = np.float32(np.sqrt(1.0 / (2 * (spec.n - spec.m) / spec.n * p
                                      * 10 ** (ebn0 / 10))))
    rng = np.random.default_rng(seed)
    y = 1.0 + sigma * rng.standard_normal((frames, spec.n, p)).astype(np.float32)
    return (-(2.0 / sigma**2) * (y @ bits.T)).astype(np.float32)


MODES = {"early_term": dict(early_term=True),
         "throughput": dict(early_term=False, stats_each_iter=False)}
# CN updates through the wrappers a "kernel" decode calls (on CPU tensors
# their plain versions)
DECODERS = {
    "qspa": common.full_width(lambda U, _g: cn_qspa.cn_update(U)),
    "ems": common.full_width(lambda U, _g: cn_ems.cn_update(U, 8, 0.3)),
    "ems_bubble": common.full_width(lambda U, _g: cn_ems.cn_update_bubble(U, 8, 0.0)),
    "tems": lambda U, _g, active, out: cn_tems.cn_update(U, 2.0, 4, active, out),
}


def _same(a, b) -> None:
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cn", list(DECODERS))
def test_decode_bl_kernel_route_equals_torch_route(small_codes, cn, mode):
    spec = irregular_spec(16, 4)
    tg = port_graph(spec)
    llr = torch.from_numpy(_llrs(spec, 12, 2.0, seed=7))
    fn = DECODERS[cn]
    counts = (route.route_down_plain.calls, route.route_up_plain.calls)
    ref = common.decode_bl(tg, llr, fn, 6, route="torch", **MODES[mode])
    got = common.decode_bl(tg, llr, fn, 6, route="kernel", **MODES[mode])
    _same(got, ref)
    # both ran the plain routing, once an iteration each
    iters = 2 * (int(ref.iters.max()) if mode == "early_term" else 6)
    assert (route.route_down_plain.calls - counts[0], route.route_up_plain.calls - counts[1]) \
        == (iters, iters)
    with pytest.raises(ValueError, match="route"):
        common.decode_bl(tg, llr, fn, 1, route="cuda")


# (port decode, JAX decode, shared kwargs, JAX's XLA-path kwargs)
AGAINST_JAX = {
    "qspa": (qspa.decode, jqspa.decode, {}, {"cn_impl": "xla"}),
    "ems": (ems.decode, jems.decode, {"nm": 8, "offset": 0.3}, {"use_pallas": "no"}),
    "tems": (tems.decode, jtems.decode, {"offset": 2.0, "n_r": 4}, {"use_pallas": "no"}),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dec", list(AGAINST_JAX))
def test_kernel_path_matches_jax_with_cn_and_vn_pads(dec, mode):
    """The port's "kernel" path (the check-node and routing wrappers, on
    the CPU their plain versions) against JAX's decode_bl, frame for
    frame, on a code with CN and VN pad slots."""
    spec = irregular_spec(16, 4)
    llr = _llrs(spec, 16, 2.0, seed=11)
    port, jax_dec, kw, jkw = AGAINST_JAX[dec]
    kw = {"max_iters": 8, **kw, **MODES[mode]}
    ref = jax_dec(jgraph.TannerGraph(spec), jnp.asarray(llr), **kw, **jkw)
    got = port(port_graph(spec), torch.from_numpy(llr), cn_impl="kernel", **kw)
    _same((got.hard, got.done, got.iters), (ref.hard, ref.done, ref.iters))


# (decoder, cn_impl, kwargs, whether decode_bl routes through the wrappers)
DISPATCH = [
    ("qspa", "kernel", {}, True), ("qspa", "torch", {}, False), ("qspa", "auto", {}, False),
    ("qspa", "resident", {}, False),
    ("ems", "kernel", {"nm": 4}, True), ("ems", "torch", {"nm": 4}, False),
    ("ems", "auto", {"nm": 4}, False), ("ems", "resident", {"nm": 4}, False),
    ("ems", "kernel", {"nm": 4, "merge": "bubble"}, True),
    ("ems", "torch", {"nm": 4, "merge": "bubble"}, False),
    ("tems", "kernel", {"n_r": 2}, True), ("tems", "torch", {"n_r": 2}, False),
    ("tems", "auto", {"n_r": 2}, False),
]


@pytest.mark.parametrize("dec,cn_impl,kw,kernel", DISPATCH)
def test_decoders_route_through_the_wrappers_exactly_on_the_kernel_path(
        small_codes, monkeypatch, dec, cn_impl, kw, kernel):
    spec = small_codes["gf16_irr"]
    tg = port_graph(spec)
    llr = torch.from_numpy(_llrs(spec, 4, 1.0, seed=3))
    seen = {"down": 0, "up": 0}

    def down(*args):
        seen["down"] += 1
        return route.route_down_plain(*args)

    def up(*args):
        seen["up"] += 1
        return route.route_up_plain(*args)

    monkeypatch.setattr(route, "route_down", down)
    monkeypatch.setattr(route, "route_up", up)
    plain = (route.route_down_plain.calls, route.route_up_plain.calls)
    res = {"qspa": qspa, "ems": ems, "tems": tems}[dec].decode(
        tg, llr, max_iters=3, early_term=False, cn_impl=cn_impl, **kw)
    assert res.hard.shape == (4, tg.n)
    calls = (route.route_down_plain.calls - plain[0], route.route_up_plain.calls - plain[1])
    if kernel:
        assert seen == {"down": 3, "up": 3} and calls == (3, 3)
    else:
        assert seen == {"down": 0, "up": 0}
        assert calls == ((0, 0) if cn_impl == "resident" else (3, 3))
