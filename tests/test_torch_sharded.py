"""The port's edge-sharded decode (decoders/sharded.py) on 2 and 4 gloo ranks
on the CPU: hard/done/iters equal to the port's decode_bl and to JAX's
decode_edge_sharded on the same numpy LLRs, in both early_term modes, with
the QSPA check node and with the EMS (classic and bubble merges) and T-EMS
check nodes. Rank workers are spawned through tests/test_torch_mesh.py's
run_ranks, once per rank count for every case, and import no JAX."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init, modulate
from nbldpc_tpu_torch.codegen import make_peg_code
from nbldpc_tpu_torch.decoders import common, ems, qspa, sharded, tems
from nbldpc_tpu_torch.encode import Encoder
from nbldpc_tpu_torch.graph import TannerGraph

from tests.test_torch_mesh import run_ranks

torch.set_num_threads(1)

ITERS = 6
# (the code of tests/test_sharded.py: M = 32, N = 64, GF(16); frames)
CODE = (64, 32, 16, 2, 2)
FRAMES = 16
# the other check nodes, batch-last, as (module attribute, keyword
# arguments), the same in both packages: EMS at nm < q with its offset
# (BASELINE config 3's decoder), classic and bubble merges, and T-EMS
# with the exact two-deviation scan and with n_r = 4
OTHER_CNS = {"ems_classic": ("ems", "ems_cn_update_bl", {"nm": 8, "offset": 0.3}),
             "ems_bubble": ("ems", "ems_cn_update_bl",
                            {"nm": 8, "offset": 0.3, "merge": "bubble"}),
             "tems": ("tems", "tems_cn_update_bl", {"offset": 0.5}),
             "tems_nr4": ("tems", "tems_cn_update_bl", {"offset": 0.5, "n_r": 4})}


def _port_cn(cn):
    module, name, kwargs = OTHER_CNS[cn]
    return functools.partial(getattr({"ems": ems, "tems": tems}[module], name), **kwargs)


def _llrs():
    """{name: llr [B, N, q] float32}: random codewords at 2.0 dB (most
    frames converge, at different iterations, some fail) and at 4.0 dB
    (every frame converges: the early-termination loop stops early)."""
    n, m, q, dv, seed = CODE
    spec = make_peg_code(n, m, q, dv=dv, seed=seed)
    enc = Encoder(spec, "cpu")
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.integers(0, q, size=(FRAMES, enc.k)).astype(np.int32))
    x = modulate(enc.encode(u), q)
    out = {}
    for name, ebn0 in (("2.0dB", 2.0), ("4.0dB", 4.0)):
        sigma = float(ebn0_to_sigma(ebn0, spec.k / spec.n))
        noise = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        out[name] = llr_init(x + sigma * noise, sigma, q).numpy()
    return spec, out


def _decodes(rank, llrs):
    """The sharded decode of every LLR set, in both early_term modes: with
    the QSPA check node under (name, early), with each of OTHER_CNS under
    (cn, name, early)."""
    spec = make_peg_code(*CODE[:3], dv=CODE[3], seed=CODE[4])
    g = TannerGraph(spec, "cpu")
    cns = {None: qspa.qspa_cn_update_bl, **{cn: _port_cn(cn) for cn in OTHER_CNS}}
    out = {}
    for cn, fn in cns.items():
        for name, llr in llrs.items():
            for early in (True, False):
                got = sharded.decode_edge_sharded(g, torch.from_numpy(llr), fn, ITERS, early)
                out[(name, early) if cn is None else (cn, name, early)] = tuple(
                    t.numpy() for t in got)
    return out


@pytest.fixture(scope="module")
def setup():
    return _llrs()


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    _, llrs = setup
    return {world: run_ranks(tmp_path_factory.mktemp(f"sharded{world}"), world, _decodes,
                             llrs)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("name", ["2.0dB", "4.0dB"])
def test_sharded_equals_decode_bl(setup, ranks, world, early, name):
    spec, llrs = setup
    ref = common.decode_bl(TannerGraph(spec, "cpu"), torch.from_numpy(llrs[name]),
                           common.full_width(qspa.qspa_cn_update_bl), ITERS, early)
    want = tuple(t.numpy() for t in ref)
    for r, got in enumerate(ranks[world]):
        for a, b, what in zip(got[(name, early)], want, ("hard", "done", "iters")):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}: {what}")
    done, iters = want[1], want[2]
    if name == "2.0dB":
        assert 0 < done.sum() < FRAMES and len(set(iters[done].tolist())) > 1
    else:
        assert done.all() and iters.max() < ITERS


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("name", ["2.0dB", "4.0dB"])
def test_sharded_equals_jax_sharded(setup, ranks, world, early, name):
    import jax
    from jax.sharding import Mesh

    from nbldpc_tpu.codegen import make_peg_code as jax_make_peg_code
    from nbldpc_tpu.decoders import qspa as jqspa
    from nbldpc_tpu.decoders import sharded as jsharded
    from nbldpc_tpu.graph import TannerGraph as JaxGraph

    _, llrs = setup
    g = JaxGraph(jax_make_peg_code(*CODE[:3], dv=CODE[3], seed=CODE[4]))
    jmesh = Mesh(np.asarray(jax.devices()[:world]), ("edge",))
    with jmesh:
        res = jax.jit(lambda x: jsharded.decode_edge_sharded(
            g, x, jmesh, jqspa.qspa_cn_update_bl, ITERS, early_term=early))(llrs[name])
    got = ranks[world][0][(name, early)]
    for a, b, what in zip(got, res, ("hard", "done", "iters")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("name", ["2.0dB", "4.0dB"])
@pytest.mark.parametrize("cn", list(OTHER_CNS))
def test_sharded_other_cns_equal_decode_bl(setup, ranks, cn, world, early, name):
    spec, llrs = setup
    ref = common.decode_bl(TannerGraph(spec, "cpu"), torch.from_numpy(llrs[name]),
                           common.full_width(_port_cn(cn)), ITERS, early)
    want = tuple(t.numpy() for t in ref)
    for r, got in enumerate(ranks[world]):
        for a, b, what in zip(got[(cn, name, early)], want, ("hard", "done", "iters")):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}: {what}")
    if name == "2.0dB":
        assert 0 < want[1].sum() < FRAMES


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("cn", list(OTHER_CNS))
def test_sharded_other_cns_equal_jax_sharded(setup, ranks, cn, world, early):
    """At 2.0 dB (frames that converge at different iterations and frames
    that fail), JAX's decode_edge_sharded with its batch-last check node."""
    import jax
    from jax.sharding import Mesh

    from nbldpc_tpu.codegen import make_peg_code as jax_make_peg_code
    from nbldpc_tpu.decoders import ems as jems
    from nbldpc_tpu.decoders import sharded as jsharded
    from nbldpc_tpu.decoders import tems as jtems
    from nbldpc_tpu.graph import TannerGraph as JaxGraph

    _, llrs = setup
    module, fname, kwargs = OTHER_CNS[cn]
    jcn = functools.partial(getattr({"ems": jems, "tems": jtems}[module], fname), **kwargs)
    g = JaxGraph(jax_make_peg_code(*CODE[:3], dv=CODE[3], seed=CODE[4]))
    jmesh = Mesh(np.asarray(jax.devices()[:world]), ("edge",))
    with jmesh:
        res = jax.jit(lambda x: jsharded.decode_edge_sharded(
            g, x, jmesh, jcn, ITERS, early_term=early))(llrs["2.0dB"])
    got = ranks[world][0][(cn, "2.0dB", early)]
    for a, b, what in zip(got, res, ("hard", "done", "iters")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)


def test_shard_plan_routes_every_edge_once():
    """Across the ranks the two exchanges send each real edge exactly once,
    and a code that does not divide is refused."""
    spec = make_peg_code(*CODE[:3], dv=CODE[3], seed=CODE[4])
    g = TannerGraph(spec, "cpu")
    edges = int(g.np["cn_mask"].sum())
    for world in (1, 2, 4, 8):
        plans = [sharded.shard_plan(g, world, r) for r in range(world)]
        for route in ("down", "up"):
            sent = np.array([getattr(p, route).send_split for p in plans])
            recv = np.array([getattr(p, route).recv_split for p in plans])
            assert (sent == recv.T).all() and sent.sum() == edges
    with pytest.raises(ValueError, match="must divide by 3"):
        sharded.shard_plan(g, 3, 0)


def test_single_rank_group_equals_decode_bl(setup, tmp_path):
    """A one-rank group: the exchanges are local copies."""
    spec, llrs = setup
    g = TannerGraph(spec, "cpu")
    llr = torch.from_numpy(llrs["2.0dB"])
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        got = sharded.decode_edge_sharded(g, llr, qspa.qspa_cn_update_bl, ITERS)
    finally:
        tdist.destroy_process_group()
    want = common.decode_bl(g, llr, common.full_width(qspa.qspa_cn_update_bl), ITERS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
