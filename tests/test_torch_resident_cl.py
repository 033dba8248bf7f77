"""The port's resident QSPA decode for large fields (plain version, as it
runs on the CPU) against the JAX package's checks-on-lanes resident
kernel ResidentQSPA (K0-cl, its QSPA default above GF(32)) in interpret
mode: hard decisions, done flags and iteration counts equal frame for
frame, on batches where some frames converge and some do not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbldpc_tpu.graph as jgraph
from nbldpc_tpu.codegen import make_peg_code
from nbldpc_tpu.kernels.qspa_resident import ResidentQSPA as JaxResidentQSPA

from nbldpc_tpu_torch.kernels import qspa_resident as qr

from tests.test_torch_qspa import noisy_llrs, port_graph

torch.set_num_threads(1)

# (q, max_iters, early_term, stats_each_iter): GF(64) in the three loop
# modes of test_torch_resident.py, GF(256) (about 25 s of JAX interpret
# per call) in one
CASES = {"gf64_early_term": (64, 8, True, True), "gf64_fixed": (64, 8, False, True),
         "gf64_throughput": (64, 6, False, False), "gf256_early_term": (256, 6, True, True)}
# PEG dv = 2 codes small enough for interpret mode: (n, m) per field
SHAPES = {64: (24, 8), 256: (20, 6)}
# 2.0 dB: 10-12 of the 16 frames converge within the budget, the rest fail
EBN0_DB = 2.0


@pytest.mark.parametrize("case", list(CASES))
def test_resident_cl_plain_matches_jax_interpret(case):
    q, iters, et, stats = CASES[case]
    spec = make_peg_code(*SHAPES[q], q, dv=2, seed=3)
    _, llr = noisy_llrs(spec, 16, EBN0_DB, seed=4)
    h_j, d_j, i_j = JaxResidentQSPA(jgraph.TannerGraph(spec), iters, et,
                                    stats_each_iter=stats)(
        jnp.asarray(llr), tb=16, interpret=True)
    dec = qr.ResidentQSPA(port_graph(spec), iters, et, stats)
    launches = qr.resident_decode.launches, qr.resident_decode_cl.launches
    h, d, i = qr.resident_decode(dec, torch.from_numpy(llr))
    # CPU: the plain version, no kernel
    assert (qr.resident_decode.launches, qr.resident_decode_cl.launches) == launches
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert 0 < int(d.sum()) < len(d)              # converged and failed frames
