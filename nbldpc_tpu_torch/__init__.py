"""nbldpc_tpu_torch: the non-binary LDPC decode-and-simulate framework on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package nbldpc_tpu, which stays the reference; this
package imports neither JAX nor nbldpc_tpu. Modules keep the reference's
names:

  - GF(2^p) tables                                       (gf.py)
  - alist codes and Tanner-graph index tables           (code.py, graph.py)
  - BPSK binary image, AWGN, LLR-vector init            (channel.py)
  - systematic encoder, PEG / QC code generation        (encode.py, codegen.py)
  - the host C++ library: GF tables, row reduction, BFS (native.py)
  - QSPA and EMS decoders and their shared loop         (decoders/)
  - CUDA kernels and their plain PyTorch versions       (kernels/, csrc/)
  - Monte-Carlo BER/FER engine, CLI, benchmark          (sim.py, cli.py, bench.py)
  - runs across processes on torch.distributed          (parallel/, decoders/sharded.py)
"""

__version__ = "0.1.0"

from nbldpc_tpu_torch.gf import GF
from nbldpc_tpu_torch.code import CodeSpec, load_alist, save_alist
from nbldpc_tpu_torch.graph import TannerGraph
