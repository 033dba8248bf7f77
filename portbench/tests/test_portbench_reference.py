"""The reference against hand-worked cases at tiny sizes, and against the
program's plain check nodes on the same inputs."""

import itertools

import numpy as np
import pytest
import torch

from portbench import reference


def test_gf4_and_gf16_tables():
    mul, inv = reference.field_tables(4)
    # GF(4) = {0, 1, a, a + 1} with a^2 = a + 1
    assert mul.tolist() == [[0, 0, 0, 0], [0, 1, 2, 3], [0, 2, 3, 1], [0, 3, 1, 2]]
    assert inv.tolist() == [0, 1, 3, 2]
    mul, inv = reference.field_tables(16)
    assert all(mul[a, inv[a]] == 1 for a in range(1, 16))
    assert mul[2, 8] == 3                         # x * x^3 = x^4 = x + 1


def test_channel_llr_by_hand():
    # q = 4, sigma 1: y = 1 + n; llr[a] = -2 (y0 b0(a) + y1 b1(a))
    noise = torch.tensor([[[[0.5, -3.0]]]])
    llr = reference.channel_llr(noise, [1.0], 4)
    y0, y1 = 1.5, -2.0
    assert llr.flatten().tolist() == pytest.approx([0.0, -2 * y0, -2 * y1, -2 * (y0 + y1)])


def test_step_noise_is_the_documented_draw():
    s = np.random.SeedSequence([2**31 + 7, 3]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(s))
    want = torch.randn((2, 3, 4, 2), generator=g)
    assert torch.equal(reference.step_noise(2**31 + 7, 3, (2, 3, 4, 2), "cpu"), want)


def _xor_conv(a, b):
    out = np.zeros(len(a))
    for i in range(len(a)):
        for j in range(len(b)):
            out[i ^ j] += a[i] * b[j]
    return out


def _tiny_code():
    # two checks of degree 3 over GF(4) on three variables of degree 2
    return reference.Code(q=4, n=3, m=2, dv=2, check_deg=np.array([3, 3]),
                          edge_var=np.array([0, 1, 2, 0, 1, 2]),
                          edge_w=np.array([1, 2, 3, 3, 1, 2]),
                          var_edges=np.array([[0, 3], [1, 4], [2, 5]]))


def test_qspa_check_is_the_xor_convolution_of_the_other_edges():
    code = _tiny_code()
    dec = reference.Decoder(code, "cpu", "qspa", 5, dtype=torch.float64)
    rng = np.random.default_rng(1)
    U = torch.from_numpy(rng.normal(size=(1, 1, 3, 4)) * 2)
    U = U - U.amax(dim=-1, keepdim=True)
    out = dec.check_qspa(U)[0, 0].numpy()
    P = torch.softmax(U, -1)[0, 0].numpy()
    for j in range(3):
        others = [P[k] for k in range(3) if k != j]
        want = np.log(np.maximum(_xor_conv(*others), reference.PROB_FLOOR))
        assert out[j] == pytest.approx(want - want.max(), abs=1e-9)


def _tems_brute(U, offset):
    """Every path of at most two deviations from the column maxima, columns
    other than j distinct: dW_j(eta) = max value, C_j(a) = dW_j(a ^ beta ^ z_j)."""
    dc, q = U.shape
    z = U.argmax(axis=1)
    dU = np.stack([U[i, np.arange(q) ^ z[i]] for i in range(dc)])
    beta = np.bitwise_xor.reduce(z)
    out = np.zeros((dc, q))
    for j in range(dc):
        others = [i for i in range(dc) if i != j]
        dw = np.full(q, -np.inf)
        dw[0] = 0.0
        for i in others:
            for e in range(1, q):
                dw[e] = max(dw[e], dU[i, e])
        for i1, i2 in itertools.combinations(others, 2):
            for e1 in range(1, q):
                for e2 in range(1, q):
                    if e1 ^ e2:
                        dw[e1 ^ e2] = max(dw[e1 ^ e2], dU[i1, e1] + dU[i2, e2])
        c = dw[np.arange(q) ^ beta ^ z[j]]
        out[j] = np.minimum(c - c.max() + offset, 0.0)
    return out


@pytest.mark.parametrize("q,dc,seed", [(4, 3, 0), (8, 4, 1), (8, 5, 2), (16, 4, 3)])
def test_tems_check_exact_scan_is_the_two_deviation_brute_force(q, dc, seed):
    code = reference.Code(q=q, n=dc, m=1, dv=1, check_deg=np.array([dc]),
                          edge_var=np.arange(dc),
                          edge_w=np.ones(dc, np.int64), var_edges=np.arange(dc)[:, None])
    dec = reference.Decoder(code, "cpu", "tems", 5, offset=0.7, n_r=0, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(dc, q)) * 3
    U = U - U.max(axis=1, keepdims=True)
    got = dec.check_tems(torch.from_numpy(U)[None, None])[0, 0].numpy()
    assert got == pytest.approx(_tems_brute(U, 0.7), abs=1e-9)


def test_tems_check_matches_the_programs_plain_core():
    from nbldpc_tpu_torch.decoders import tems

    code = reference.load_code("gf64_n576_k480")
    dec = reference.Decoder(code, "cpu", "tems", 20, offset=2.0, n_r=8)
    g = torch.Generator().manual_seed(5)
    U = torch.randn((3, 4, 12, 64), generator=g) * 4                 # [A, M, dc, q]
    U = U - U.amax(dim=-1, keepdim=True)
    got = dec.check_tems(U)
    want = tems.tems_cn_update_bl(U.permute(1, 2, 3, 0).contiguous(), None, 2.0, 8)
    assert torch.equal(got, want.permute(3, 0, 1, 2))


def test_qspa_check_matches_the_programs_plain_check_node():
    from nbldpc_tpu_torch.kernels import cn_qspa

    code = reference.load_code("gf16_n204_k102")
    dec = reference.Decoder(code, "cpu", "qspa", 50)
    g = torch.Generator().manual_seed(6)
    U = torch.randn((5, 7, 4, 16), generator=g) * 3
    U = U - U.amax(dim=-1, keepdim=True)
    want = cn_qspa.cn_update_plain(U.permute(1, 2, 3, 0).contiguous()).permute(3, 0, 1, 2)
    assert torch.allclose(dec.check_qspa(U), want, atol=2e-4)


@pytest.mark.parametrize("kind", ["qspa", "tems"])
def test_decode_and_counters_by_hand(kind):
    """Clean LLRs of the zero codeword decode at once; one symbol flipped in
    frame 1 is corrected within a few iterations; a frame whose LLRs all
    point at symbol 1 is never done."""
    name = "gf16_n204_k102" if kind == "qspa" else "gf64_n576_k480"
    code = reference.load_code(name)
    dec = reference.Decoder(code, "cpu", kind, 20, offset=2.0, n_r=8)
    q, n = code.q, code.n
    llr = torch.full((3, n, q), -8.0)
    llr[:, :, 0] = 0.0
    llr[1, 5] = -8.0
    llr[1, 5, 3] = -1.0                                  # symbol 5 leans to 3
    llr[2] = -8.0
    llr[2, :, 1] = 0.0
    hard, done, iters = dec.decode(llr)
    assert done.tolist() == [True, True, False]
    assert iters[0] == 0 and 1 <= iters[1] <= 5 and iters[2] == 20
    assert int(hard[0].abs().sum()) == 0 and int(hard[1].abs().sum()) == 0
    c = reference.counters(hard, done, iters, 1, code.p)
    wrong = int((hard[2] != 0).sum())
    bits = int(sum(bin(int(x)).count("1") for x in hard[2]))
    assert c[:, 0].tolist() == [3, 1, wrong, bits, int(iters.sum()), 2]
