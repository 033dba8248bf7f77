"""Checkpoint/resume for Monte-Carlo sweeps.

The sim state is (macro-batch cursor, per-SNR counters). Batch t's noise
comes from a generator seeded by (seed, t) alone, so resuming from
(t, counters) is exact. Writes are atomic (tmp + rename) and stamped with
the config hash; a hash mismatch refuses to resume. The file format is the
JAX package's, so either package can resume the other's counters.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np


class Checkpointer:
    def __init__(self, path, config_hash: str):
        self.path = Path(path)
        self.config_hash = config_hash

    def save(self, step: int, counters) -> None:
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
