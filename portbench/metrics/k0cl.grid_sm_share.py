"""How much of the card K0-cl's persistent grid holds: the blocks of the
cluster kernel's grids (the program's `qspa_cluster.grid_blocks` counter)
over its launches (`qspa_resident_cl` and `qspa_resident_cl_bf16`) times
the card's SMs. None where the window launched no cluster kernel, where
the program has no such counter, or where no card is there to ask."""


def _sm_count():
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def read(ctx):
    launches = ctx["launches"]
    blocks = launches.get("qspa_cluster.grid_blocks")
    n = launches.get("qspa_resident_cl", 0) + launches.get("qspa_resident_cl_bf16", 0)
    if not blocks or not n:
        return None
    sms = _sm_count()
    return 100.0 * blocks / (n * sms) if sms else None
