"""The Monte-Carlo step's work around the decode (CUDA kernels + plain
versions): the channel, decode_bl's entry and the error counters.

  channel_llr(noise [S, B, N, p], sig [S], q, cw [S, B, N] | None) -> llr [S, B, N, q]
      BPSK of the codeword (all zero when cw is None) plus sig * noise, then
      channel.llr_init: the body of sim.make_sim_step's frames() before the
      decode;
  prior_bl(llr [B, N, q]) -> (prior [N, q, B], hard0 [N, B] int32)
      decode_bl's entry: the LLRs batch-last, normalized so the max over q
      is 0, and their decision (the lowest symbol of a tie, as argmax_q);
  count_errors(hard [S B, N], cw | None, iters [S B], done [S B], S, B, p)
      -> {name: int64 [S]}: the step's six counters, in sim.Counters' keys.

Each launches its kernel (csrc/sim_step.cu) for CUDA tensors and runs its
plain version for CPU tensors. The kernels replace no Pallas kernel: JAX's
jitted sim step leaves this work to XLA (nbldpc_tpu/sim.py:151-167,
decoders/common.py:200-204). They agree with the plain versions bit for bit:
the channel and the entry use only the plain versions' IEEE operations in
their order (the build has no fused multiply-adds), and the counters are
integer sums.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.channel import llr_init, modulate

COUNTERS = ("frames", "frame_errors", "symbol_errors", "bit_errors", "iter_sum", "converged")


def channel_llr_plain(noise: torch.Tensor, sig: torch.Tensor, q: int,
                      cw: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch channel_llr: (noise, sig, cw) -> llr [S, B, N, q]."""
    channel_llr_plain.calls += 1
    sig = sig.to(torch.float32)[:, None, None, None]                 # [S,1,1,1]
    if cw is None:
        y = 1.0 + sig * noise                    # BPSK of the zero codeword
    else:
        y = modulate(cw, q) + sig * noise
    return llr_init(y, sig, q)                                       # [S,B,N,q]


def prior_bl_plain(llr: torch.Tensor) -> tuple:
    """Plain PyTorch prior_bl: llr [B, N, q] -> (prior [N, q, B], hard0 [N, B])."""
    prior_bl_plain.calls += 1
    prior = llr.permute(1, 2, 0)                                     # [N, q, B]
    prior = (prior - prior.amax(dim=1, keepdim=True)).contiguous()
    return prior, torch.argmax(prior, dim=1).to(torch.int32)        # argmax_q


def count_errors_plain(hard: torch.Tensor, cw: torch.Tensor | None, iters: torch.Tensor,
                       done: torch.Tensor, S: int, B: int, p: int) -> dict:
    """Plain PyTorch count_errors: the step's counters {name: int64 [S]}."""
    count_errors_plain.calls += 1
    diff = hard.reshape(S, B, hard.shape[-1])
    if cw is not None:
        diff = diff ^ cw
    sym_err = diff != 0
    bit_err = sum(((diff >> t) & 1) for t in range(p))
    return {
        "frames": torch.full((S,), B, dtype=torch.int64, device=hard.device),
        "frame_errors": sym_err.any(dim=-1).sum(dim=1),
        "symbol_errors": sym_err.sum(dim=(1, 2)),
        "bit_errors": bit_err.sum(dim=(1, 2), dtype=torch.int64),
        "iter_sum": iters.reshape(S, B).sum(dim=1, dtype=torch.int64),
        "converged": done.reshape(S, B).sum(dim=1),
    }


channel_llr_plain.calls = 0
prior_bl_plain.calls = 0
count_errors_plain.calls = 0


def _check(name: str, device, **tensors) -> None:
    """Raise ValueError unless every tensor (label=(tensor, dtype, shape), or
    None where the input is optional) is a contiguous CUDA tensor on `device`
    of its dtype and shape."""
    for label, spec in tensors.items():
        if spec is None:
            continue
        t, dtype, shape = spec
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: {label} on {t.device}, expected {device}")
        if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} tensor of shape "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _check_q(name: str, q: int) -> None:
    from nbldpc_tpu_torch.kernels import _build

    if q not in _build.QS:
        raise ValueError(f"{name}: q={q} unsupported")


def channel_llr(noise: torch.Tensor, sig: torch.Tensor, q: int,
                cw: torch.Tensor | None = None) -> torch.Tensor:
    """(noise [S, B, N, p] f32, sig [S], q, cw [S, B, N] int32 | None) ->
    llr [S, B, N, q] f32: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if noise.device.type == "cpu":
        return channel_llr_plain(noise, sig, q, cw)
    _check_q("channel_llr", q)
    if noise.ndim != 4:
        raise ValueError(f"channel_llr: noise must be [S, B, N, p], got {tuple(noise.shape)}")
    S, B, N, p = noise.shape
    sig = sig.to(torch.float32).contiguous()
    _check("channel_llr", noise.device,
           noise=(noise, torch.float32, (S, B, N, q.bit_length() - 1)),
           sig=(sig, torch.float32, (S,)),
           cw=None if cw is None else (cw, torch.int32, (S, B, N)))
    llr = torch.empty((S, B, N, q), dtype=torch.float32, device=noise.device)
    if llr.numel():
        from nbldpc_tpu_torch.kernels import _build

        scale = 2.0 / sig ** 2                   # the plain version's ops (llr_init)
        _build.launch(channel_llr, "channel_llr", noise.device, noise.data_ptr(),
                      sig.data_ptr(), scale.data_ptr(), 0 if cw is None else cw.data_ptr(),
                      llr.data_ptr(), S, B, N, q)
    return llr


def prior_bl(llr: torch.Tensor) -> tuple:
    """llr [B, N, q] f32 -> (prior [N, q, B] f32, hard0 [N, B] int32): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if llr.device.type == "cpu":
        return prior_bl_plain(llr)
    if llr.ndim != 3:
        raise ValueError(f"prior_bl: llr must be [B, N, q], got {tuple(llr.shape)}")
    B, N, q = llr.shape
    _check_q("prior_bl", q)
    _check("prior_bl", llr.device, llr=(llr, torch.float32, (B, N, q)))
    prior = torch.empty((N, q, B), dtype=torch.float32, device=llr.device)
    hard = torch.empty((N, B), dtype=torch.int32, device=llr.device)
    if prior.numel():
        from nbldpc_tpu_torch.kernels import _build

        _build.launch(prior_bl, "prior_bl", llr.device, llr.data_ptr(), prior.data_ptr(),
                      hard.data_ptr(), N, q, B)
    return prior, hard


def count_errors(hard: torch.Tensor, cw: torch.Tensor | None, iters: torch.Tensor,
                 done: torch.Tensor, S: int, B: int, p: int) -> dict:
    """(hard [S B, N] int32, cw [S, B, N] int32 | None, iters [S B] int32,
    done [S B] bool, S, B, p) -> {name: int64 [S]} (COUNTERS): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if hard.device.type == "cpu":
        return count_errors_plain(hard, cw, iters, done, S, B, p)
    _check_q("count_errors", 1 << p)
    if hard.ndim != 2:
        raise ValueError(f"count_errors: hard must be [S B, N], got {tuple(hard.shape)}")
    N = hard.shape[1]
    _check("count_errors", hard.device, hard=(hard, torch.int32, (S * B, N)),
           cw=None if cw is None else (cw, torch.int32, (S, B, N)),
           iters=(iters, torch.int32, (S * B,)), done=(done, torch.bool, (S * B,)))
    out = torch.zeros((len(COUNTERS), S), dtype=torch.int64, device=hard.device)
    if S and B:
        from nbldpc_tpu_torch.kernels import _build

        _build.launch(count_errors, "count_errors", hard.device, hard.data_ptr(),
                      0 if cw is None else cw.data_ptr(), iters.data_ptr(), done.data_ptr(),
                      out.data_ptr(), S, B, N, p)
    return dict(zip(COUNTERS, out))


channel_llr.launches = 0
prior_bl.launches = 0
count_errors.launches = 0
