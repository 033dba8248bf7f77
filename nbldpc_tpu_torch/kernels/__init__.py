"""Hand-written CUDA kernels for Hopper (csrc/) and their plain PyTorch
versions, one module a kernel family.

Every kernel wrapper counts its launches on an attribute of its own
(`launches`, `launches_bf16`), and every plain version its calls
(`calls`). `counted` is the registry of every counter of the program:
those, under the kernel's name, and the layers' own counters under dotted
names (`sweep.loop_ns` on sim.run_sweep, `decode_bl.loop_iterations` and
`decode_bl.frame_iterations` on decoders/common.decode_bl,
`cn_tems.frame_iterations` on cn_tems.cn_update: the frames the T-EMS
check node computed, kernel or plain version; `qspa_cluster.grid_blocks`
and `qspa_cluster.frame_slots` on qspa_resident.resident_decode_cl: the
blocks of the persistent grid each launch of K0-cl's cluster kernel had,
and its frame slots (its clusters, a frame each), as the library reports
them, either precision), so that a run
can zero them before a path and read which kernels it launched, whether a
plain version ran and what its layers counted. The submodules are
imported only when the counters are read: importing this package builds
and loads nothing.
"""

from __future__ import annotations


def counted() -> list:
    """(name, function, attribute) of every counter of the program: each
    kernel wrapper's and plain version's (no dot in the name), then the
    layers' (a dot)."""
    from nbldpc_tpu_torch import sim
    from nbldpc_tpu_torch.decoders import common
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
            *((f"micro_{fn.__name__}", fn, "launches") for fn in micro.WRAPPERS),
            ("sweep.loop_ns", sim.run_sweep, "loop_ns"),
            ("decode_bl.loop_iterations", common.decode_bl, "loop_iterations"),
            ("decode_bl.frame_iterations", common.decode_bl, "frame_iterations"),
            ("cn_tems.frame_iterations", cn_tems.cn_update, "frame_iterations"),
            ("qspa_cluster.grid_blocks", qr.resident_decode_cl, "grid_blocks"),
            ("qspa_cluster.frame_slots", qr.resident_decode_cl, "frame_slots")]


def launch_counts() -> dict:
    """{name: count} of every counter of the program (`counted`)."""
    return {name: getattr(fn, attr) for name, fn, attr in counted()}


def reset_launch_counts() -> None:
    """Set every counter of the program (`counted`) to 0."""
    for _, fn, attr in counted():
        setattr(fn, attr, 0)
