"""The ('snr', 'data') layout of a process group's ranks.

Rank r sits at (r // data, r % data) of a snr x data grid and decodes a
contiguous block of a step's [S, B] batch: SNR slots [S/snr] and frames
[B/data]. The JAX package's mesh shards the same axes over devices
(nbldpc_tpu/parallel/mesh.py); here one process drives one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


def grid(world: int, snr: int = 1, data: int = 0) -> tuple:
    """(snr, data) of a layout over `world` ranks; data = 0: every rank the
    SNR axis leaves. Every rank must hold a block."""
    if snr < 1 or data < 0:
        raise ValueError(f"snr={snr}, data={data}: expected snr >= 1, data >= 0")
    if data == 0:
        if world % snr:
            raise ValueError(f"{world} ranks not divisible by snr={snr}")
        data = world // snr
    if snr * data != world:
        raise ValueError(f"a {snr} x {data} layout needs {snr * data} ranks, "
                         f"the group has {world}")
    return snr, data


@dataclasses.dataclass(frozen=True)
class Layout:
    """One rank's place in a snr x data grid of a process group (None: the
    default group)."""

    snr: int
    data: int
    rank: int
    group: Optional[Any] = None

    @property
    def coords(self) -> tuple:
        return divmod(self.rank, self.data)

    def block(self, n_snr: int, frames: int) -> tuple:
        """(slots, frames): the slices of a step's [n_snr, frames] batch that
        this rank decodes."""
        if n_snr % self.snr:
            raise ValueError(f"{n_snr} SNR points not divisible by snr={self.snr}")
        if frames % self.data:
            raise ValueError(f"{frames} frames a step not divisible by data={self.data}")
        i, j = self.coords
        s, b = n_snr // self.snr, frames // self.data
        return slice(i * s, (i + 1) * s), slice(j * b, (j + 1) * b)


def make_layout(snr: int = 1, data: int = 0, group=None) -> Layout:
    """The layout of this process in `group` (None: the default group, which
    must be initialized)."""
    import torch.distributed as tdist

    world, rank = tdist.get_world_size(group), tdist.get_rank(group)
    return Layout(*grid(world, snr, data), rank=rank, group=group)
