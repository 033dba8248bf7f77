"""Runs across processes on torch.distributed: the ('snr', 'data') layout of
a process group's ranks (mesh.py) and joining the group (dist.py).

Each SNR point and each frame of a Monte-Carlo step is independent, so
the only traffic between ranks of a sweep is the per-step all-reduce of
the error counters (sim.run_sweep). decoders/sharded.py splits one
decode's code graph over the ranks instead.
"""

from nbldpc_tpu_torch.parallel.mesh import Layout, make_layout
