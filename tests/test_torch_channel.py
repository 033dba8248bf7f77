"""The port's channel functions match the JAX package's on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.channel as jch

from nbldpc_tpu_torch import channel as tch

torch.set_num_threads(1)


@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_llr_init_and_modulate_match(q):
    rng = np.random.default_rng(q)
    p = q.bit_length() - 1
    sym = rng.integers(0, q, size=(3, 5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tch.modulate(torch.from_numpy(sym), q).numpy(),
        np.asarray(jch.modulate(jnp.asarray(sym), q)))

    # one sigma per SNR point, broadcast as [S, 1, 1, 1]; and a scalar
    y = rng.standard_normal((3, 5, 7, p)).astype(np.float32)
    sig = np.asarray([0.5, 0.8, 1.1], np.float32)[:, None, None, None]
    for s in (sig, 0.63):
        want = np.asarray(jch.llr_init(jnp.asarray(y), jnp.asarray(s), q))
        s_t = torch.from_numpy(s) if isinstance(s, np.ndarray) else s
        got = tch.llr_init(torch.from_numpy(y), s_t, q).numpy()
        assert got.shape == want.shape == (3, 5, 7, q)
        # f32 sums of p terms, in possibly different order: a few ulp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ebn0_to_sigma_matches():
    snr = np.linspace(-1.0, 4.0, 11)
    np.testing.assert_array_equal(tch.ebn0_to_sigma(snr, 0.5),
                                  jch.ebn0_to_sigma(snr, 0.5))


@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_wht_matches_jax(q):
    from nbldpc_tpu.kernels import wht as jwht

    from nbldpc_tpu_torch.kernels import wht as twht

    H = twht.wht_matrix(q)
    np.testing.assert_array_equal(H, jwht.wht_matrix(q))
    x = np.random.default_rng(q).standard_normal((3, q, 5)).astype(np.float32)
    got = twht.wht_axis(torch.from_numpy(x), axis=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jwht.wht_axis(jnp.asarray(x), 1)))
    np.testing.assert_allclose(got, np.einsum("ab,ibj->iaj", H, x), rtol=1e-5, atol=1e-4)


def test_transmit_reproducible_from_generator():
    cw = torch.zeros((4, 10), dtype=torch.int64)
    a = tch.transmit(torch.Generator().manual_seed(3), cw, 0.7, 16)
    b = tch.transmit(torch.Generator().manual_seed(3), cw, 0.7, 16)
    assert a.shape == (4, 10, 16)
    assert torch.equal(a, b)
