"""Checkpoint/resume for Monte-Carlo sweeps.

The sim state is (macro-batch cursor, per-SNR counters). Batch t's noise
comes from a generator seeded by (seed, t) alone, so resuming from
(t, counters) is exact. Writes are atomic (tmp + rename) and stamped with
the config hash; a hash mismatch refuses to resume. The file format is the
JAX package's, so either package can resume the other's counters.

Across processes every rank loads and only rank 0 writes: the counters
are all-reduced each step, so rank 0 holds what every rank holds. No rank
can finish a step's all-reduce before every rank has entered that step,
so every load precedes rank 0's first save of the run. (A sweep resumed
already finished runs no step; rank 0 then rewrites the loaded state, and
the atomic rename hands a concurrent reader the old or the new file,
which are the same.)
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from nbldpc_tpu_torch.parallel.dist import process_info


class Checkpointer:
    def __init__(self, path, config_hash: str):
        self.path = Path(path)
        self.config_hash = config_hash

    def save(self, step: int, counters) -> None:
        if process_info()[0] != 0:
            return
        payload = {
            "config_hash": self.config_hash,
            "step": int(step),
            "counters": counters.asdict(),
        }
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, self.path)

    def load(self) -> Optional[tuple]:
        from nbldpc_tpu_torch.sim import Counters

        if not self.path.exists():
            return None
        payload = json.loads(self.path.read_text())
        if payload["config_hash"] != self.config_hash:
            raise ValueError(
                f"checkpoint {self.path} was written by a different config "
                f"({payload['config_hash']} != {self.config_hash})"
            )
        raw = payload["counters"]
        c = Counters.zeros(len(raw["frames"]))
        for k, v in raw.items():
            getattr(c, k)[...] = np.asarray(v, np.int64)
        return payload["step"], c
