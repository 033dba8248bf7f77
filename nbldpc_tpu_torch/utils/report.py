"""Structured results: JSONL metrics stream + final report.

Counters live on the device during a macro-batch; the host fetches them
once per step. This module only formats and persists them, in the JAX
package's formats.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

from nbldpc_tpu_torch.parallel.dist import process_info

logger = logging.getLogger("nbldpc")


def setup_logging(level=logging.INFO):
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    return logger


def emit_step_record(step: int, counters):
    """One JSON line per macro-batch: the cumulative per-SNR counters."""
    logger.info(json.dumps({"t": time.time(), "step": step, **counters.asdict()}))


def sweep_report(result, cfg=None) -> dict:
    """Serializable summary of a SweepResult."""
    rep = {
        "config_hash": result.config_hash,
        "ebn0_db": list(result.ebn0_db),
        "ber": [float(x) for x in result.ber],
        "ser": [float(x) for x in result.ser],
        "fer": [float(x) for x in result.fer],
        "avg_iters": [float(x) for x in result.avg_iters],
        "frames": result.counters.frames.tolist(),
        "frame_errors": result.counters.frame_errors.tolist(),
        "wall_seconds": result.wall_seconds,
        "throughput_syms_per_s": float(result.throughput_syms_per_s),
        "steps": result.steps,
    }
    if cfg is not None:
        rep["config"] = dataclasses.asdict(cfg)
    return rep


def save_report(result, path, cfg=None) -> None:
    """Write the report; across processes rank 0 alone writes (every rank
    holds the same all-reduced counters)."""
    if process_info()[0] != 0:
        return
    Path(path).write_text(json.dumps(sweep_report(result, cfg), indent=2, default=list))
