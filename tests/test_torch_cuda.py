"""CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX (the machine with the card has none) and skip
without a card. Run them there with:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nbldpc_tpu_torch.channel import ebn0_to_sigma, llr_init
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import cn_qspa
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
