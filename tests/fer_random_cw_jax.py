"""The JAX package's FER in random-codeword mode beside its all-zero FER,
on the CPU: the yardstick of the port's random-codeword FER gate where
the reference decoder is not codeword-symmetric.

    JAX_PLATFORMS=cpu python -m tests.fer_random_cw_jax

The records in benchmarks/results/fer_curves_r5.json decode the all-zero
codeword. Under channel and decoder symmetry they hold for any codeword.
The reference's EMS is not symmetric where nm < q: its top-nm extraction
and the compensation fill of the truncated entries break value ties toward
the lowest symbol, which is the transmitted one only for the all-zero
codeword. This script decodes gf256_ems_nm16_10it (GF(256) (255,175), EMS
nm 16, 10 iterations) at 2.5 dB, 1024 frames in each mode from seed 3, and
writes to tests/data/fer_random_cw_jax.json a record in fer_curves_r5.json's
format for the random-codeword run (config name + "_random_cw"), with the
all-zero run's counts beside it. chip_smoke.py phase random_cw reads it.
It takes about 12 minutes on the CPU (JAX's EMS at GF(256): ~0.36 s a frame).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

OUT = Path(__file__).resolve().parent / "data" / "fer_random_cw_jax.json"

NAME = "gf256_ems_nm16_10it"  # fer_curves_r5.json's name
CODE = "gf256_n255_k175"
DECODER = {"kind": "ems", "max_iters": 10, "nm": 16, "offset": 0.1}
EBN0_DB = 2.5
FRAMES = 1024
FRAMES_PER_STEP = 64
SEED = 3


def run() -> dict:
    import nbldpc_tpu.sim as jsim
    import nbldpc_tpu.utils.config as jcfg

    counts = {}
    for zero in (True, False):
        cfg = jcfg.RunConfig(
            code=jcfg.CodeConfig(name=CODE), decoder=jcfg.DecoderConfig(**DECODER),
            channel=jcfg.ChannelConfig(ebn0_db=(EBN0_DB,), zero_codeword=zero),
            sim=jcfg.SimConfig(frames_per_step=FRAMES_PER_STEP, max_frames=FRAMES,
                               max_frame_errors=10**9, seed=SEED))
        t0 = time.perf_counter()
        res = jsim.run_sweep(cfg)
        counts[zero] = (int(res.counters.frames[0]), int(res.counters.frame_errors[0]),
                        time.perf_counter() - t0)
    (n, k, secs), (n0, k0, secs0) = counts[False], counts[True]
    return {"config": f"{NAME}_random_cw", "code": CODE, "decoder": DECODER, "seed": SEED,
            "zero_codeword": False, "ebn0_db": [EBN0_DB], "frames": [n],
            "frame_errors": [k], "fer": [k / n], "seconds": secs,
            "zero_codeword_frames": [n0], "zero_codeword_frame_errors": [k0],
            "zero_codeword_fer": [k0 / n0], "zero_codeword_seconds": secs0}


def main() -> int:
    rec = run()
    print(json.dumps(rec), flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps([rec], indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
