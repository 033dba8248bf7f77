"""Hand-written CUDA kernels for Hopper (csrc/) and their plain PyTorch
versions, one module a kernel family.

Every kernel wrapper counts its launches on an attribute of its own
(`launches`, `launches_bf16`), and every plain version its calls
(`calls`); `counted` lists them all, so that a run can zero them before a
path and read which kernels it launched and whether a plain version ran.
The submodules are imported only when the counters are read: importing
this package builds and loads nothing.
"""

from __future__ import annotations


def counted() -> list:
    """(name, function, attribute) of every kernel wrapper and plain version."""
    from nbldpc_tpu_torch.kernels import cn_ems, cn_qspa, cn_tems, micro, route, sim_step
    from nbldpc_tpu_torch.kernels import ems_resident as er
    from nbldpc_tpu_torch.kernels import qspa_resident as qr

    return [("qspa_resident", qr.resident_decode, "launches"),
            ("qspa_resident_cl", qr.resident_decode_cl, "launches"),
            ("qspa_resident_cl_scratch", qr.resident_decode_cl_scratch, "launches"),
            ("qspa_resident_bf16", qr.resident_decode, "launches_bf16"),
            ("qspa_resident_cl_bf16", qr.resident_decode_cl, "launches_bf16"),
            ("qspa_resident_cl_scratch_bf16", qr.resident_decode_cl_scratch, "launches_bf16"),
            ("qspa_resident_plain", qr.decode_plain, "calls"),
            ("cn_qspa", cn_qspa.cn_update, "launches"),
            ("cn_qspa_plain", cn_qspa.cn_update_plain, "calls"),
            ("ems_resident", er.resident_decode, "launches"),
            ("ems_resident_plain", er.decode_plain, "calls"),
            ("cn_ems", cn_ems.cn_update, "launches"),
            ("cn_ems_plain", cn_ems.cn_update_plain, "calls"),
            ("cn_ems_bubble", cn_ems.cn_update_bubble, "launches"),
            ("cn_ems_bubble_plain", cn_ems.cn_update_bubble_plain, "calls"),
            ("cn_tems", cn_tems.cn_update, "launches"),
            ("cn_tems_plain", cn_tems.cn_update_plain, "calls"),
            ("route_down", route.route_down, "launches"),
            ("route_down_plain", route.route_down_plain, "calls"),
            ("route_up", route.route_up, "launches"),
            ("route_up_plain", route.route_up_plain, "calls"),
            ("channel_llr", sim_step.channel_llr, "launches"),
            ("channel_llr_plain", sim_step.channel_llr_plain, "calls"),
            ("prior_bl", sim_step.prior_bl, "launches"),
            ("prior_bl_plain", sim_step.prior_bl_plain, "calls"),
            ("count_errors", sim_step.count_errors, "launches"),
            ("count_errors_plain", sim_step.count_errors_plain, "calls"),
            *((f"micro_{fn.__name__}", fn, "launches") for fn in micro.WRAPPERS)]


def launch_counts() -> dict:
    """{name: count} of every counter in `counted`."""
    return {name: getattr(fn, attr) for name, fn, attr in counted()}


def reset_launch_counts() -> None:
    """Set every counter in `counted` to 0."""
    for _, fn, attr in counted():
        setattr(fn, attr, 0)
