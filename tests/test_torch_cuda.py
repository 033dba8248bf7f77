"""CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX (the machine with the card has none) and skip
without a card. Run them there with:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems
from nbldpc_tpu_torch.kernels import ems_resident as er
from nbldpc_tpu_torch.kernels import qspa_resident as qr
from nbldpc_tpu_torch.utils.config import CodeConfig

CODES = Path(__file__).resolve().parents[1] / "codes"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _graph(name, device):
    return TannerGraph(CodeConfig(path=str(CODES / f"{name}.alist")).load(), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["gf4_n96_k48", "gf16_n204_k102", "gf64_n576_k480",
                                  "gf256_n255_k175"])
def test_cn_kernel_matches_plain(cuda_device, code):
    g = _graph(code, cuda_device)
    rng = np.random.default_rng(1)
    Vv = torch.from_numpy((rng.standard_normal((g.n, g.dv_max, g.q, 200)) * 3.0)
                          .astype(np.float32)).to(cuda_device)
    U = g.gather_cn_x_bl(Vv).contiguous()
    before = cn_qspa.cn_update.launches
    out = cn_qspa.cn_update(U)
    assert cn_qspa.cn_update.launches == before + 1
    ref = cn_qspa.cn_update_plain(U)
    real = g.cn_mask[:, :, None, None].expand_as(ref)
    assert bool(torch.isfinite(out[real]).all())
    # same association order; exp/log may differ by an ulp, which the
    # inverse WHT's cancellation amplifies only in the deep log tail
    assert float((out - ref).abs()[real & (ref > -15)].max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, False, True), (20, True, True), (20, False, False)])
@pytest.mark.parametrize("code", ["gf4_n96_k48", "gf16_n204_k102_c8"])
def test_resident_kernel_matches_plain(cuda_device, code, mode):
    g = _graph(code, cuda_device)
    B = 300                                    # not a multiple of any tile
    sigma = float(ebn0_to_sigma(1.5, g.spec.k / g.n))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    y = 1.0 + sigma * torch.randn((B, g.n, g.gf.p), generator=gen, device=cuda_device)
    llr = llr_init(y, sigma, g.q).contiguous()
    dec = qr.ResidentQSPA(g, *mode)
    before = qr.resident_decode.launches
    hk, dk, ik = qr.resident_decode(dec, llr)
    assert qr.resident_decode.launches == before + 1
    hp, dp, ip = qr.decode_plain(dec, llr)
    same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
    # exact but for ulp-level ties of exp/log that a later iteration may amplify
    assert float(same.float().mean()) >= (0.999 if mode[0] == 1 else 0.99)


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda_device):
    g = _graph("gf16_n204_k102", cuda_device)
    dec = qr.ResidentQSPA(g, 2)
    with pytest.raises(ValueError):
        qr.resident_decode(dec, torch.zeros((4, g.n, g.q), dtype=torch.float64,
                                            device=cuda_device))
    with pytest.raises(ValueError):
        cn_qspa.cn_update(torch.zeros((2, 4, 16, 8), device=cuda_device).transpose(0, 1))


def _random_u(g, B, device, seed=1):
    rng = np.random.default_rng(seed)
    Vv = torch.from_numpy((rng.standard_normal((g.n, g.dv_max, g.q, B)) * 3.0)
                          .astype(np.float32)).to(device)
    return g.gather_cn_x_bl(Vv).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["classic", "bubble"])
@pytest.mark.parametrize("code,nm", [("gf4_n96_k48", 2), ("gf16_n204_k102", 8),
                                     ("gf16_n204_k102", 16), ("gf64_n576_k480", 8),
                                     ("gf256_n255_k175", 16)])
def test_cn_ems_kernels_match_plain(cuda_device, code, nm, merge):
    g = _graph(code, cuda_device)
    U = _random_u(g, 37, cuda_device)             # not a multiple of any tile
    kern, plain = ((cn_ems.cn_update, cn_ems.cn_update_plain) if merge == "classic"
                   else (cn_ems.cn_update_bubble, cn_ems.cn_update_bubble_plain))
    before = kern.launches
    out = kern(U, nm, 0.2)
    assert kern.launches == before + 1
    ref = plain(U, nm, 0.2)
    assert bool(torch.isfinite(out).all())
    # only adds and max, in the plain version's association: exact
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, False, True), (20, True, True), (20, False, False)])
@pytest.mark.parametrize("code,nm", [("gf4_n96_k48", 4), ("gf16_n204_k102", 16),
                                     ("gf16_n204_k102", 8)])
def test_resident_ems_kernel_matches_plain(cuda_device, code, nm, mode):
    g = _graph(code, cuda_device)
    B = 300
    sigma = float(ebn0_to_sigma(1.5, g.spec.k / g.n))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    y = 1.0 + sigma * torch.randn((B, g.n, g.gf.p), generator=gen, device=cuda_device)
    llr = llr_init(y, sigma, g.q).contiguous()
    dec = er.ResidentEMS(g, mode[0], nm, 0.3, mode[1], mode[2])
    before = er.resident_decode.launches
    hk, dk, ik = er.resident_decode(dec, llr)
    assert er.resident_decode.launches == before + 1
    hp, dp, ip = er.decode_plain(dec, llr)
    same = (hk == hp).all(dim=1) & (dk == dp) & (ik == ip)
    assert float(same.float().mean()) == 1.0


@pytest.mark.cuda
def test_ems_wrappers_reject_bad_input(cuda_device):
    g = _graph("gf16_n204_k102", cuda_device)
    dec = er.ResidentEMS(g, 2, 8, 0.3)
    with pytest.raises(ValueError):
        er.resident_decode(dec, torch.zeros((4, g.n, g.q), dtype=torch.float64,
                                            device=cuda_device))
    with pytest.raises(ValueError):
        er.resident_decode(dec, torch.zeros((4, g.n + 1, g.q), device=cuda_device))
    bad = torch.zeros((2, 4, 16, 8), device=cuda_device).transpose(0, 1)
    for fn in (cn_ems.cn_update, cn_ems.cn_update_bubble):
        with pytest.raises(ValueError):
            fn(bad, 8, 0.0)
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 4, 12, 8), device=cuda_device), 8, 0.0)
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 1, 16, 8), device=cuda_device), 8, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("code,n_r", [("gf16_n204_k102", 0), ("gf16_n204_k102", 8),
                                      ("gf64_n576_k480", 0), ("gf64_n576_k480", 8),
                                      ("gf256_n255_k175", 8)])
def test_cn_tems_kernel_matches_plain(cuda_device, code, n_r):
    g = _graph(code, cuda_device)
    U = _random_u(g, 37, cuda_device)             # not a multiple of any tile
    before = cn_tems.cn_update.launches
    out = cn_tems.cn_update(U, 2.0, n_r)
    assert cn_tems.cn_update.launches == before + 1
    ref = cn_tems.cn_update_plain(U, 2.0, n_r)
    assert bool(torch.isfinite(out).all())
    # one add per candidate, the rest max and select: exact
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
def test_cn_tems_wrapper_rejects_bad_input(cuda_device):
    good = torch.zeros((2, 4, 16, 8), device=cuda_device)
    with pytest.raises(ValueError, match="device"):
        cn_tems._launch(good.cpu(), 0.0, 0)                # the kernel takes no CPU tensor
    for bad in (good.double(),                             # wrong dtype
                good.transpose(0, 1),                      # not contiguous
                torch.zeros((2, 2, 16, 8), device=cuda_device),    # dc < 3
                torch.zeros((2, 4, 12, 8), device=cuda_device),    # q not a power of 2
                torch.zeros((2, 4, 512, 8), device=cuda_device)):  # q above 256
        with pytest.raises(ValueError):
            cn_tems.cn_update(bad, 0.0, 0)
    with pytest.raises(ValueError, match="n_r"):
        cn_tems.cn_update(good, 0.0, 16)                   # n_r >= q
    before = cn_tems.cn_update.launches
    cn_tems.cn_update(good, 0.0, 15)
    assert cn_tems.cn_update.launches == before + 1
