"""Joining a torch.distributed process group from the environment.

Two environments name a group:
  - torch.distributed.run's: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT
    (and LOCAL_RANK, the card of a rank on its host);
  - the JAX package's manual one: NBLDPC_COORDINATOR (host:port, or an
    init-method URL such as file:///path/store), NBLDPC_NUM_PROCS and
    NBLDPC_PROC_ID.
With neither, a run is a single process and joins no group. A group the
process cannot join raises; nothing falls back to a single process.

Determinism: a sweep's frames are drawn from (seed, step) alone, never
from the rank, so every layout and process count simulates the same
frames (sim.run_sweep).
"""

from __future__ import annotations

import os
from typing import Optional

_NBLDPC_VARS = ("NBLDPC_COORDINATOR", "NBLDPC_NUM_PROCS", "NBLDPC_PROC_ID")


def local_rank() -> int:
    """This process's card on its host (torch.distributed.run's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def _group_env() -> Optional[tuple]:
    """(init method, world size, rank) of the group the environment names;
    None for a single-process run."""
    env = os.environ
    given = [v for v in _NBLDPC_VARS if v in env]
    if given:
        if len(given) < len(_NBLDPC_VARS):
            raise ValueError(f"{', '.join(given)} set without "
                             f"{', '.join(v for v in _NBLDPC_VARS if v not in env)}")
        coord = env["NBLDPC_COORDINATOR"]
        init_method = coord if "://" in coord else f"tcp://{coord}"
        return init_method, int(env["NBLDPC_NUM_PROCS"]), int(env["NBLDPC_PROC_ID"])
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def declared_world() -> int:
    """The size of the group the environment names (1 for a single
    process), read before joining it."""
    group = _group_env()
    return 1 if group is None else group[1]


def initialize(device_type: str = "cpu", backend: Optional[str] = None) -> bool:
    """Join the process group the environment names (see the module
    docstring); False, and nothing joined, for a single-process run.

    backend: "nccl" or "gloo"; None takes NCCL for device_type "cuda" and
    gloo for the CPU. Two ranks that share one card need gloo: NCCL
    refuses them."""
    import torch.distributed as tdist

    if tdist.is_initialized():
        return True
    group = _group_env()
    if group is None:
        return False
    init_method, world, rank = group
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    tdist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def process_info() -> tuple:
    """(rank, world size) in the default group; (0, 1) outside any group."""
    import torch.distributed as tdist

    if not tdist.is_initialized():
        return 0, 1
    return tdist.get_rank(), tdist.get_world_size()
