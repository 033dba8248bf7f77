"""The routing of one decode_bl iteration, batch-last (CUDA kernels + plain
versions): the two halves around the check-node update.

  route_down(posterior [N, q, B], Cv [N, dv_max, q, B], graph) -> U [M, dc_max, q, B]
      the leave-one-out posterior - Cv, normalized so the max over q is 0,
      routed to the check-node slots through graph.down_idx (the GF weight
      permutation included); pad CN slots get log-delta0;
  route_up(Chat [M, dc_max, q, B], llr [N, q, B], graph) -> (Cv, posterior)
      the check-node outputs routed back through graph.up_idx (0 on pad VN
      slots), and posterior = llr + the sum over the slots.

Each launches its kernel (csrc/route.cu) for CUDA tensors and runs its
plain version for CPU tensors. The kernels replace no Pallas kernel: JAX's
decode_bl leaves these two scopes of its loop body to XLA. Only
subtractions, a max and adds are involved, in the plain versions'
association on the card, so the kernels agree with them bit for bit. The
slot sum `Cv.sum(dim=1)` adds left to right on the CPU (as XLA does) and,
on the card, in torch's CUDA association: four accumulators, slot k into
accumulator k mod 4, added in order; the two agree for dv_max <= 4.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.graph import TannerGraph


def route_down_plain(posterior: torch.Tensor, Cv: torch.Tensor,
                     graph: TannerGraph) -> torch.Tensor:
    """Plain PyTorch route_down: (posterior, Cv) -> U [M, dc_max, q, B]."""
    route_down_plain.calls += 1
    Vv = posterior[:, None] - Cv                           # leave-one-out
    Vv = Vv - Vv.amax(dim=2, keepdim=True)                 # normalize (q)
    return graph.gather_cn_x_bl(Vv)                        # [M, dc, q, B]


def route_up_plain(Chat: torch.Tensor, llr: torch.Tensor,
                   graph: TannerGraph) -> tuple:
    """Plain PyTorch route_up: (Chat, llr) -> (Cv [N, dv_max, q, B], posterior [N, q, B])."""
    route_up_plain.calls += 1
    Cv = graph.gather_vn_x_bl(Chat)                        # [N, dv, q, B]
    return Cv, llr + Cv.sum(dim=1)


route_down_plain.calls = 0
route_up_plain.calls = 0


def _check(name: str, graph: TannerGraph, idx: torch.Tensor, mask: torch.Tensor,
           **tensors) -> None:
    """Raise ValueError unless every tensor is a contiguous float32 CUDA
    tensor of its expected shape on the device of the graph's tables, the
    tables (idx, mask) are contiguous int32 and bool, and q is one the
    kernels take."""
    from nbldpc_tpu_torch.kernels import _build

    if graph.q not in _build.QS:
        raise ValueError(f"{name}: q={graph.q} unsupported")
    if (idx.dtype != torch.int32 or mask.dtype != torch.bool or not idx.is_contiguous()
            or not mask.is_contiguous()):
        raise ValueError(f"{name}: the graph's tables must be contiguous int32 and bool")
    for label, (t, shape) in tensors.items():
        if t.device.type != "cuda" or t.device != idx.device:
            raise ValueError(f"{name}: {label} on {t.device}, the graph's tables on "
                             f"{idx.device}")
        if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be a contiguous float32 tensor of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")


def route_down(posterior: torch.Tensor, Cv: torch.Tensor, graph: TannerGraph) -> torch.Tensor:
    """(posterior [N, q, B], Cv [N, dv_max, q, B]) f32 -> U [M, dc_max, q, B]:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if posterior.device.type == "cpu":
        return route_down_plain(posterior, Cv, graph)
    N, dv, q, B = graph.n, graph.dv_max, graph.q, posterior.shape[-1]
    _check("route_down", graph, graph.down_idx, graph.cn_mask,
           posterior=(posterior, (N, q, B)), Cv=(Cv, (N, dv, q, B)))
    U = torch.empty((graph.m, graph.dc_max, q, B), dtype=torch.float32,
                    device=posterior.device)
    if B:
        from nbldpc_tpu_torch.kernels import _build

        _build.launch(route_down, "route_down", posterior.device, posterior.data_ptr(),
                      Cv.data_ptr(), U.data_ptr(), graph.down_idx.data_ptr(),
                      graph.cn_mask.data_ptr(), graph.m * graph.dc_max, dv, q, B)
    return U


def route_up(Chat: torch.Tensor, llr: torch.Tensor, graph: TannerGraph) -> tuple:
    """(Chat [M, dc_max, q, B], llr [N, q, B]) f32 -> (Cv [N, dv_max, q, B],
    posterior [N, q, B]): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if Chat.device.type == "cpu":
        return route_up_plain(Chat, llr, graph)
    N, dv, q, B = graph.n, graph.dv_max, graph.q, llr.shape[-1]
    _check("route_up", graph, graph.up_idx, graph.vn_mask,
           Chat=(Chat, (graph.m, graph.dc_max, q, B)), llr=(llr, (N, q, B)))
    Cv = torch.empty((N, dv, q, B), dtype=torch.float32, device=llr.device)
    posterior = torch.empty((N, q, B), dtype=torch.float32, device=llr.device)
    if B:
        from nbldpc_tpu_torch.kernels import _build

        _build.launch(route_up, "route_up", llr.device, Chat.data_ptr(), llr.data_ptr(),
                      Cv.data_ptr(), posterior.data_ptr(), graph.up_idx.data_ptr(),
                      graph.vn_mask.data_ptr(), N, dv, q, B)
    return Cv, posterior


route_down.launches = 0
route_up.launches = 0
