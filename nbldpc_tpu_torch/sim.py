"""Monte-Carlo BER/SER/FER simulation engine.

One `step` processes [S, B] frames, all SNR points at once (per-SNR sigma
is data), through (encode -> modulate ->) noise -> llr_init -> decode ->
error counters. The host loop accumulates per-SNR counters until every
SNR point hits its stop rule (max frames or max frame errors); it fetches
the counters once per step.

Across processes (a parallel.mesh.Layout), rank r decodes its block of
[S/snr] SNR slots x [B/data] frames and the step's counters are
all-reduced: the only traffic between ranks. Every rank draws the whole
step's noise and keeps its block, so each frame is decoded on exactly one
rank and the counters equal a single process's for every layout.

Spans (utils/trace.py) mark each piece of the host loop and of the step
on torch.profiler's timeline: `sweep.plan`, `sweep.generator`,
`sweep.fetch`, `sweep.account`, `sweep.checkpoint` and `step.noise`,
`step.channel`, `step.decode`, `step.count`. run_sweep.loop_ns counts the
nanoseconds of the loop's own four (plan, generator, account,
checkpoint), always, with the kernels' launch counters
(kernels.counted).

Reproducibility: the noise of macro-batch t (and, in random-codeword mode,
its info symbols) comes from a torch.Generator seeded from (seed, t)
through np.random.SeedSequence, so a resumed sweep draws exactly the
frames an uninterrupted one would.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as tdist

from nbldpc_tpu_torch.channel import ebn0_to_sigma
from nbldpc_tpu_torch.decoders import ems, qspa, tems
from nbldpc_tpu_torch.encode import Encoder
from nbldpc_tpu_torch.gf import get_field
from nbldpc_tpu_torch.graph import TannerGraph
from nbldpc_tpu_torch.kernels import sim_step
from nbldpc_tpu_torch.utils.config import DecoderConfig, RunConfig
from nbldpc_tpu_torch.utils.trace import span


def get_cn_update(dec: DecoderConfig):
    """The q-last CN update ([B, M, dc, q], graph) -> same of the configured
    decoder, as the JAX package's: T-EMS gets its offset and not
    dec.tems_nr, so it runs the exact scan."""
    if dec.kind == "qspa":
        return qspa.qspa_cn_update
    if dec.kind == "ems":
        return functools.partial(ems.ems_cn_update, nm=dec.nm, offset=dec.offset)
    if dec.kind == "tems":
        return functools.partial(tems.tems_cn_update, offset=dec.offset)
    raise ValueError(f"unknown decoder kind {dec.kind!r}")


def get_decode_fn(dec: DecoderConfig, cn_impl: str = "auto"):
    """(graph, llr [B,N,q]) -> DecodeResult for the configured decoder."""
    if dec.kind == "qspa":
        return lambda graph, llr: qspa.decode(
            graph, llr, dec.max_iters, dec.early_term, cn_impl=cn_impl,
            mm_precision=dec.mm_precision, stats_each_iter=dec.stats_each_iter,
        )
    if dec.kind == "ems":
        return lambda graph, llr: ems.decode(
            graph, llr, dec.max_iters, nm=dec.nm, offset=dec.offset,
            early_term=dec.early_term, cn_impl=cn_impl,
            stats_each_iter=dec.stats_each_iter, merge=dec.ems_merge,
        )
    if dec.kind == "tems":
        return lambda graph, llr: tems.decode(
            graph, llr, dec.max_iters, offset=dec.offset, early_term=dec.early_term,
            cn_impl=cn_impl, stats_each_iter=dec.stats_each_iter, n_r=dec.tems_nr,
        )
    raise ValueError(f"unknown decoder kind {dec.kind!r}")


def step_generator(seed: int, t: int, device) -> torch.Generator:
    """The noise generator of macro-batch t, a function of (seed, t) only."""
    s = np.random.SeedSequence([int(seed), int(t)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s))
    return gen


@dataclasses.dataclass
class Counters:
    """Per-SNR Monte-Carlo accumulators (host-side numpy)."""

    frames: np.ndarray
    frame_errors: np.ndarray
    symbol_errors: np.ndarray
    bit_errors: np.ndarray
    iter_sum: np.ndarray
    converged: np.ndarray

    @staticmethod
    def zeros(s: int) -> "Counters":
        z = lambda: np.zeros(s, dtype=np.int64)
        return Counters(z(), z(), z(), z(), z(), z())

    def add(self, step_out: dict) -> None:
        for f in dataclasses.fields(self):
            getattr(self, f.name)[...] += np.asarray(step_out[f.name], np.int64)

    def asdict(self) -> dict:
        return {f.name: getattr(self, f.name).tolist() for f in dataclasses.fields(self)}


def make_sim_step(
    graph: TannerGraph,
    dec: DecoderConfig,
    batch_per_snr: int,
    n_snr: int,
    encoder: Optional[Encoder] = None,
    cn_impl: str = "auto",
    block: Optional[tuple] = None,
) -> Callable:
    """Build step(gen, sigmas [S] f32 on the graph's device) -> counters
    {name: int64 tensor [S]} on the device.

    The step draws the noise of S*B frames from `gen` and, given an
    `encoder` (random-codeword mode), then their info symbols [S, B, K] in
    [0, q); it encodes them, modulates, adds the noise, computes LLRs,
    decodes and counts errors against the codewords. With no encoder every
    frame is the all-zero codeword and no symbols are drawn, so both modes
    draw the same noise from the same generator. The channel and the
    counters run through kernels/sim_step.py's wrappers (their CUDA kernels
    on the card), or through their plain versions with cn_impl="torch".

    block: (slots, frames) slices of the [S, B] batch (Layout.block): the
    step still draws the whole batch, decodes only the block and returns
    the block's counters [S_r] (step.block is the block). step.frames(
    sigmas, noise, u) runs the same step on given draws of any [S', B'] (u
    None: the all-zero codeword)."""
    decode_fn = get_decode_fn(dec, cn_impl)
    S, B, N, p, q = n_snr, batch_per_snr, graph.n, graph.gf.p, graph.q
    device = graph.device
    if cn_impl == "torch":
        channel, count = sim_step.channel_llr_plain, sim_step.count_errors_plain
    else:
        channel, count = sim_step.channel_llr, sim_step.count_errors

    def frames(sigmas: torch.Tensor, noise: torch.Tensor, u=None) -> dict:
        S, B = noise.shape[:2]
        with span("step.channel"):
            cw = None if u is None else encoder.encode(u)             # [S,B,N]
            llr = channel(noise, sigmas, q, cw)                        # [S,B,N,q]
        with span("step.decode"):
            res = decode_fn(graph, llr.reshape(S * B, N, q))
        with span("step.count"):
            return count(res.hard, cw, res.iters, res.done, S, B, p)

    def step(gen: torch.Generator, sigmas: torch.Tensor) -> dict:
        with span("step.noise"):
            noise = torch.randn((S, B, N, p), generator=gen, device=device)
            u = None if encoder is None else torch.randint(
                0, q, (S, B, encoder.k), generator=gen, device=device, dtype=torch.int32)
            if block is not None:
                slots, frame_block = block
                noise, sigmas = noise[slots, frame_block].contiguous(), sigmas[slots]
                u = None if u is None else u[slots, frame_block]
        return frames(sigmas, noise, u)

    step.frames = frames
    step.block = block
    return step


def stack(out: dict) -> torch.Tensor:
    """Step counters -> one int64 tensor [6, S'] in Counters' field order."""
    return torch.stack([out[f.name].to(torch.int64) for f in dataclasses.fields(Counters)])


def fetch(out) -> dict:
    """Device counters (a step's dict, or its stack) -> host numpy, in one
    transfer."""
    host = (stack(out) if isinstance(out, dict) else out).cpu().numpy()
    return dict(zip((f.name for f in dataclasses.fields(Counters)), host))


def step_counters(step, gen: torch.Generator, sigmas: torch.Tensor, layout=None) -> dict:
    """One step's counters on the host (fetch). Under `layout`, `step` decodes
    this rank's block (make_sim_step's `block`, layout.block): its counters
    are placed in the step's [6, S] and all-reduced over the layout's
    group, so every rank gets the whole step's."""
    out = step(gen, sigmas)
    with span("sweep.fetch"):
        out = stack(out)
        if layout is not None:
            full = torch.zeros((out.shape[0], sigmas.shape[0]), dtype=torch.int64,
                               device=out.device)
            full[:, step.block[0]] = out
            tdist.all_reduce(full, group=layout.group)
            out = full
        return fetch(out)


@dataclasses.dataclass
class SweepResult:
    ebn0_db: list
    counters: Counters
    wall_seconds: float
    steps: int
    config_hash: str = ""

    def finalize(self, n_symbols: int, p_bits: int):
        self._bits_per_frame = n_symbols * p_bits
        self._syms_per_frame = n_symbols
        return self

    @property
    def ber(self):
        f = np.maximum(self.counters.frames, 1)
        return self.counters.bit_errors / (f * self._bits_per_frame)

    @property
    def ser(self):
        f = np.maximum(self.counters.frames, 1)
        return self.counters.symbol_errors / (f * self._syms_per_frame)

    @property
    def fer(self):
        f = np.maximum(self.counters.frames, 1)
        return self.counters.frame_errors / f

    @property
    def avg_iters(self):
        f = np.maximum(self.counters.frames, 1)
        return self.counters.iter_sum / f

    @property
    def throughput_syms_per_s(self):
        total = int(self.counters.frames.sum()) * self._syms_per_frame
        return total / max(self.wall_seconds, 1e-9)

    def table(self) -> str:
        rows = ["Eb/N0(dB)   frames      BER         SER         FER      avg_iters"]
        for i, snr in enumerate(self.ebn0_db):
            rows.append(
                f"{snr:8.2f} {self.counters.frames[i]:9d}"
                f"  {self.ber[i]:.4e}  {self.ser[i]:.4e}  {self.fer[i]:.4e}"
                f"  {self.avg_iters[i]:8.2f}"
            )
        return "\n".join(rows)


def run_sweep(
    cfg: RunConfig,
    device,
    progress: Optional[Callable[[int, Counters], None]] = None,
    layout=None,
) -> SweepResult:
    """Full Monte-Carlo sweep per RunConfig on one device, or on this rank's
    block of every step under `layout` (a parallel.mesh.Layout; every rank
    of its group calls run_sweep with the same cfg). The counters, and so
    the stop rules, the slot reallocation and the result, are the same on
    every rank and equal a single process's."""
    spec = cfg.code.load()
    graph = TannerGraph(spec, device=device)
    snrs = list(cfg.channel.ebn0_db)
    S, B = len(snrs), cfg.sim.frames_per_step
    sigma_np = np.asarray([float(ebn0_to_sigma(s, spec.k / spec.n)) for s in snrs],
                          dtype=np.float32)
    encoder = None if cfg.channel.zero_codeword else Encoder(spec, graph.device)
    step = make_sim_step(graph, cfg.decoder, B, S, encoder,
                         block=None if layout is None else layout.block(S, B))

    counters = Counters.zeros(S)
    start_t = 0
    ckpt = None
    if cfg.sim.checkpoint_path:
        from nbldpc_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(cfg.sim.checkpoint_path, cfg.config_hash())
        resumed = ckpt.load()
        if resumed is not None:
            start_t, counters = resumed

    loop_ns = (run_sweep, "loop_ns")
    t0 = time.perf_counter()
    t = start_t
    while True:
        with span("sweep.plan", loop_ns):
            done = (counters.frames >= cfg.sim.max_frames) | (
                counters.frame_errors >= cfg.sim.max_frame_errors
            )
            if bool(np.all(done)):
                break
            # SNR points that hit their stop rule give their batch slots to
            # the still-active points (active points ordered by frames
            # served, filled round-robin): deterministic given the counters.
            slot_point = np.arange(S)
            n_done = int(done.sum())
            if 0 < n_done < S:
                active = np.flatnonzero(~done)
                order = active[np.argsort(counters.frames[active], kind="stable")]
                for k, s in enumerate(np.flatnonzero(done)):
                    slot_point[s] = order[k % len(order)]
            sig = torch.from_numpy(sigma_np[slot_point]).to(graph.device)
        with span("sweep.generator", loop_ns):
            gen = step_generator(cfg.sim.seed, t, graph.device)
        o = step_counters(step, gen, sig, layout)
        with span("sweep.account", loop_ns):
            if n_done:
                remapped = {}
                for name, arr in o.items():
                    acc = np.zeros(S, np.int64)
                    np.add.at(acc, slot_point, np.asarray(arr, np.int64))
                    remapped[name] = acc
                o = remapped
            counters.add(o)
            t += 1
        if progress:
            progress(t, counters)
        with span("sweep.checkpoint", loop_ns):
            if ckpt and cfg.sim.checkpoint_every and t % cfg.sim.checkpoint_every == 0:
                ckpt.save(t, counters)
    wall = time.perf_counter() - t0
    if ckpt:
        with span("sweep.checkpoint", loop_ns):
            ckpt.save(t, counters)
    res = SweepResult(
        ebn0_db=snrs,
        counters=counters,
        wall_seconds=wall,
        steps=t - start_t,
        config_hash=cfg.config_hash(),
    )
    return res.finalize(spec.n, get_field(spec.q).p)


run_sweep.loop_ns = 0
