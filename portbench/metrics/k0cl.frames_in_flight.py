"""How many frames K0-cl's cluster kernel holds on the card at once: the
frame slots of its persistent grids (the program's
`qspa_cluster.frame_slots` counter: the clusters launched, a frame each)
over its launches (`qspa_resident_cl` and `qspa_resident_cl_bf16`). None
where the window launched no cluster kernel or the program has no such
counter."""


def read(ctx):
    launches = ctx["launches"]
    slots = launches.get("qspa_cluster.frame_slots")
    n = launches.get("qspa_resident_cl", 0) + launches.get("qspa_resident_cl_bf16", 0)
    if not slots or not n:
        return None
    return slots / n
