"""Faults planted under the timed path, to show that `correct` catches
them (the CPU tests, and `calibrate --fault` at a cell's own size).

Each wraps the decode that the program's sim step builds
(nbldpc_tpu_torch.sim.get_decode_fn), so the whole run around it (the
sweep, the channel, the counters) is the program's own:
  unchanged  the decode returns the state it was given: the channel's
             decision, its syndrome, no iteration;
  half       half of each SNR slot's frames decoded, the other half given
             their results, so every count is twice the half that ran;
  altered    one symbol of one frame in sixteen altered where the decode
             writes its decisions.
One card, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


def _unchanged(fn, S):
    def decode(graph, llr):
        import torch

        from nbldpc_tpu_torch.decoders.common import DecodeResult

        hard = llr.argmax(dim=-1).to(torch.int32)
        done = (graph.syndrome(hard) == 0).all(dim=-1)
        return DecodeResult(hard, done, torch.zeros_like(hard[:, 0]))
    return decode


def _half(fn, S):
    def decode(graph, llr):
        B = llr.shape[0] // S
        rest = llr.shape[1:]
        r = fn(graph, llr.view(S, B, *rest)[:, :B // 2].reshape(-1, *rest))

        def twice(x):
            x = x.reshape(S, B // 2, *x.shape[1:])
            return x.repeat_interleave(2, dim=1).reshape(S * B, *x.shape[2:]).contiguous()
        return type(r)(twice(r.hard), twice(r.done), twice(r.iters))
    return decode


def _altered(fn, S):
    def decode(graph, llr):
        r = fn(graph, llr)
        hard = r.hard.clone()
        hard[::16, 0] ^= 1
        return type(r)(hard, r.done, r.iters)
    return decode


@contextlib.contextmanager
def planted(fault: str, n_slots: int):
    """Within the block, every sim step the program builds decodes with
    `fault` (one of FAULTS) for a step of n_slots SNR slots."""
    from nbldpc_tpu_torch import sim

    wrap = {"unchanged": _unchanged, "half": _half, "altered": _altered}[fault]
    orig = sim.get_decode_fn
    sim.get_decode_fn = lambda dec, cn_impl="auto": wrap(orig(dec, cn_impl), n_slots)
    try:
        yield
    finally:
        sim.get_decode_fn = orig
