"""The reference on a code whose checks differ in degree (BASELINE config
5's GF(256) (255,175) code: 50 checks of degree 6, 30 of degree 7), held
against the program's plain paths, which pad every check to the largest
degree; and the reference on the regular codes, held to the counters it
gave before it took such codes."""

import numpy as np
import pytest
import torch

from portbench import reference

CFG5 = "gf256_n255_k175"


@pytest.fixture(scope="module")
def cfg5():
    return reference.load_code(CFG5)


def test_the_config5_code_loads_with_its_two_check_degrees(cfg5):
    assert (cfg5.q, cfg5.n, cfg5.m, cfg5.dv) == (256, 255, 80, 2)
    assert cfg5.edges == 510 and cfg5.dc_max == 7
    assert [idx.shape for idx in cfg5.degree_groups()] == [(50, 6), (30, 7)]
    # check-major: check m's edges start where check m - 1's end
    assert cfg5.edge_start[-1] + cfg5.check_deg[-1] == cfg5.edges
    assert np.bincount(cfg5.edge_var, minlength=cfg5.n).tolist() == [2] * cfg5.n


def test_an_irregular_variable_degree_is_refused(tmp_path):
    # GF(4), 4 variables, 2 checks of degree 3: variables 0 and 1 in both,
    # 2 and 3 in one each
    (tmp_path / "vn_irregular.alist").write_text(
        "4 2 4\n2 3\n2 2 1 1\n3 3\n1 2\n1 2\n1\n2\n1 1 2 1 3 1\n1 2 4 3 2 1\n")
    with pytest.raises(ValueError, match="regular variable degree"):
        reference.load_code("vn_irregular", codes_dir=tmp_path)


def _gf_codeword(code, seed: int) -> np.ndarray:
    """A random codeword of `code`: H row-reduced over GF(q), the free
    symbols drawn from the seed, each pivot symbol solved from its row."""
    mul, inv = reference.field_tables(code.q)
    H = np.zeros((code.m, code.n), np.int64)
    rows = np.repeat(np.arange(code.m), code.check_deg)
    H[rows, code.edge_var] = code.edge_w
    pivots, r = [], 0
    for col in range(code.n):
        hit = [i for i in range(r, code.m) if H[i, col]]
        if not hit:
            continue
        H[[r, hit[0]]] = H[[hit[0], r]]
        H[r] = mul[inv[H[r, col]], H[r]]
        for i in range(code.m):
            if i != r and H[i, col]:
                H[i] ^= mul[H[i, col], H[r]]
        pivots.append(col)
        r += 1
        if r == code.m:
            break
    x = np.random.default_rng(seed).integers(0, code.q, code.n)
    x[pivots] = 0
    for i, col in enumerate(pivots):
        x[col] = np.bitwise_xor.reduce(mul[H[i], x])
    return x


def test_syndrome_is_exact_on_codewords_and_single_symbol_errors(cfg5):
    dec = reference.Decoder(cfg5, "cpu", "qspa", 1)
    words = [np.zeros(cfg5.n, np.int64)] + [_gf_codeword(cfg5, s) for s in (1, 2, 3)]
    start = cfg5.edge_start
    bad = []
    for d in (6, 7):
        check = int(np.flatnonzero(cfg5.check_deg == d)[0])
        v = int(cfg5.edge_var[start[check] + d - 1])       # the check's last symbol
        for w in words:
            e = w.copy()
            e[v] ^= 0x5a
            bad.append(e)
    ok = dec.syndrome_ok(torch.from_numpy(np.stack(words + bad)))
    assert ok.tolist() == [True] * len(words) + [False] * len(bad)


def _padded(code, U):
    """U [A, E, q] on the edges -> [M, dc_max, q, A]: each check's edges in
    its slots, the slots past its degree log-delta0 (the program's pad)."""
    from nbldpc_tpu_torch.graph import PAD_NEG

    A, _, q = U.shape
    slot = code.edge_start[:, None] + np.arange(code.dc_max)
    real = np.arange(code.dc_max) < code.check_deg[:, None]
    pad = torch.full((q,), PAD_NEG)
    pad[0] = 0.0
    out = pad.repeat(A, code.m, code.dc_max, 1)
    out[:, torch.from_numpy(real)] = U[:, torch.from_numpy(slot[real])]
    return out.permute(1, 2, 3, 0).contiguous(), real


@pytest.mark.parametrize("kind", ["qspa", "tems"])
def test_check_nodes_on_both_degree_groups_match_the_programs_padded_ones(cfg5, kind):
    from nbldpc_tpu_torch.decoders import tems
    from nbldpc_tpu_torch.kernels import cn_qspa

    dec = reference.Decoder(cfg5, "cpu", kind, 20, offset=2.0, n_r=8)
    g = torch.Generator().manual_seed(7)
    U = torch.randn((3, cfg5.edges, cfg5.q), generator=g) * 3
    U = U - U.amax(dim=-1, keepdim=True)
    got = dec.checks(U)
    Up, real = _padded(cfg5, U)
    if kind == "qspa":
        want = cn_qspa.cn_update_plain(Up)
    else:
        want = tems.tems_cn_update_bl(Up, None, 2.0, 8)
    want = want.permute(3, 0, 1, 2)[:, torch.from_numpy(real)]
    if kind == "qspa":
        assert torch.allclose(got, want, atol=2e-4)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["qspa", "tems"])
def test_whole_decode_matches_the_programs_plain_path(cfg5, kind):
    """2 slots x 8 frames at 2.0 and 3.5 dB, 20 iterations, early
    termination: done and iterations frame for frame, decisions on every
    frame both call done."""
    from nbldpc_tpu_torch.code import load_alist
    from nbldpc_tpu_torch.decoders import qspa, tems
    from nbldpc_tpu_torch.graph import TannerGraph

    ebn0, B = (2.0, 3.5), 8
    sig = [np.float32(reference.ebn0_to_sigma(e, cfg5.k / cfg5.n)) for e in ebn0]
    noise = reference.step_noise(2**31 + 26, 4, (len(ebn0), B, cfg5.n, cfg5.p), "cpu")
    llr = reference.channel_llr(noise, sig, cfg5.q).reshape(-1, cfg5.n, cfg5.q)
    hard, done, iters = reference.Decoder(cfg5, "cpu", kind, 20, offset=2.0,
                                          n_r=8).decode(llr)
    graph = TannerGraph(load_alist(reference.CODES_DIR / f"{CFG5}.alist"), "cpu")
    if kind == "qspa":
        r = qspa.decode(graph, llr, max_iters=20, early_term=True, cn_impl="torch")
    else:
        r = tems.decode(graph, llr, max_iters=20, offset=2.0, early_term=True,
                        cn_impl="torch", n_r=8)
    assert r.done.tolist() == done.tolist()
    assert r.iters.long().tolist() == iters.tolist()
    both = done & r.done
    assert torch.equal(r.hard.long()[both], hard[both])
    assert int(done.sum()) > 0 and int(iters.min()) > 0     # none done by the channel alone


# The reference's counters [6, S] of one step at fixed seeds, as the
# reference gave them before it took codes of several check degrees.
REGULAR = [
    ("gf16_n204_k102", "qspa", 50, [1.0, 2.0], 2**31 + 101, 3, 8,
     [[8, 8], [3, 0], [80, 0], [119, 0], [205, 47], [5, 8]]),
    ("gf16_n204_k102", "qspa", 50, [1.5, 3.0], 7, 0, 8,
     [[8, 8], [0, 0], [0, 0], [0, 0], [104, 33], [8, 8]]),
    ("gf64_n576_k480", "tems", 20, [3.0, 4.0], 2**31 + 102, 5, 4,
     [[4, 4], [4, 0], [259, 0], [302, 0], [80, 18], [0, 4]]),
    ("gf64_n576_k480", "tems", 20, [3.5, 4.5], 11, 1, 4,
     [[4, 4], [0, 0], [0, 0], [0, 0], [27, 9], [4, 4]]),
]


@pytest.mark.parametrize("name,kind,iters,ebn0,seed,t,B,want", REGULAR)
def test_regular_codes_give_the_counters_they_gave(name, kind, iters, ebn0, seed, t, B, want):
    code = reference.load_code(name)
    assert len(code.degree_groups()) == 1
    dec = reference.Decoder(code, "cpu", kind, iters, offset=2.0, n_r=8)
    got = reference.step_counters(code, dec, seed, t, ebn0, B, B * len(ebn0))
    assert got.tolist() == want
