"""Deterministic seeded NB-LDPC code construction (PEG), the port's copy of
the reference's generator: the same numpy draws from the same
`default_rng` seeds, so every code equals the reference's bit for bit and
`build_standard_code(name)` equals codes/<name>.alist.

The standard shapes (GF(4) (96,48), GF(16) (204,102), GF(64) (576,480),
GF(256) (255,175)) are regenerated with a Progressive-Edge-Growth
construction (Hu, Eleftheriou & Arnold 2005) and seeded random GF(q)*
edge weights. PEG places each edge of a variable at a check of least
current degree, among those the farthest from the variable in the current
subgraph (maximizing local girth), then by seeded choice; with the
min-degree rule row degrees balance to ceil/floor(E/M). Each code is
retried until H has full rank, so the systematic encoder exists.

    spec = build_standard_code("gf16_n204_k102_c8")
    spec = make_peg_code(96, 48, 4, dv=2, seed=1)
"""

from __future__ import annotations

from collections import deque

import numpy as np

from nbldpc_tpu_torch import native
from nbldpc_tpu_torch.code import CodeSpec
from nbldpc_tpu_torch.encode import gf_row_reduce
from nbldpc_tpu_torch.gf import get_field

_UNREACHED = np.iinfo(np.int64).max


def bfs_dist(vn_checks: list, cn_vars: list, v: int) -> np.ndarray:
    """Distance [m] int64 from variable v to every check of the subgraph
    given by its adjacency lists, in the native library; int64 max where
    unreachable."""
    n, m = len(vn_checks), len(cn_vars)
    vn_ptr = np.cumsum([0] + [len(x) for x in vn_checks])
    vn_adj = np.fromiter((c for x in vn_checks for c in x), np.int32, count=vn_ptr[-1])
    cn_ptr = np.cumsum([0] + [len(x) for x in cn_vars])
    cn_adj = np.fromiter((u for x in cn_vars for u in x), np.int32, count=cn_ptr[-1])
    d = native.peg_bfs(vn_ptr, vn_adj, cn_ptr, cn_adj, n, m, v).astype(np.int64)
    d[d == np.iinfo(np.int32).max] = _UNREACHED
    return d


def bfs_dist_plain(vn_checks: list, cn_vars: list, v: int) -> np.ndarray:
    """bfs_dist as a Python breadth-first search: the same distances."""
    n, m = len(vn_checks), len(cn_vars)
    dist = np.full(m, _UNREACHED, dtype=np.int64)
    seen_v = np.zeros(n, dtype=bool)
    seen_c = np.zeros(m, dtype=bool)
    seen_v[v] = True
    frontier = deque([("v", v, 0)])
    while frontier:
        kind, node, d = frontier.popleft()
        if kind == "v":
            for c in vn_checks[node]:
                if not seen_c[c]:
                    seen_c[c] = True
                    dist[c] = d + 1
                    frontier.append(("c", c, d + 1))
        else:
            for u in cn_vars[node]:
                if not seen_v[u]:
                    seen_v[u] = True
                    frontier.append(("v", u, d + 1))
    return dist


def _peg_structure(n: int, m: int, dv: np.ndarray, rng: np.random.Generator,
                   bfs=bfs_dist) -> list:
    """Binary Tanner-graph structure via PEG: each check's variables, in
    the order they were placed."""
    vn_checks = [[] for _ in range(n)]
    cn_vars = [[] for _ in range(m)]
    cn_deg = np.zeros(m, dtype=np.int64)
    for v in range(n):
        for _k in range(int(dv[v])):
            dist = bfs(vn_checks, cn_vars, v)
            # least-degree checks first (row degrees balance), then the
            # farthest (girth), then the seeded choice
            cand = np.arange(m)[~np.asarray([c in vn_checks[v] for c in range(m)])]
            if len(cand) == 0:
                raise ValueError("dv exceeds number of checks")
            degmin = cn_deg[cand].min()
            cand = cand[cn_deg[cand] == degmin]
            dmax = dist[cand].max()
            cand = cand[dist[cand] == dmax]
            c = int(cand[rng.integers(len(cand))])
            vn_checks[v].append(c)
            cn_vars[c].append(v)
            cn_deg[c] += 1
    return cn_vars


def _full_rank(spec: CodeSpec) -> bool:
    return gf_row_reduce(spec.dense_h(), get_field(spec.q))[1] == spec.m


def make_peg_code(
    n: int, m: int, q: int, dv: int = 2, seed: int = 0,
    require_full_rank: bool = True, weight_mode: str = "random",
) -> CodeSpec:
    """A (n, n-m) NB-LDPC code over GF(q) with column degree dv.

    Retries the weights (and then the structure) until H has rank m over
    GF(q). weight_mode "random": a seeded GF(q)* weight per edge; "chunk8":
    one seeded weight tuple per aligned 8-row group, slot j of every row of
    the group carrying the same weight (the same PEG graph: check labels
    are arbitrary).
    """
    dv_arr = np.full(n, dv, dtype=np.int64)
    for attempt in range(32):
        rng = np.random.default_rng([seed, attempt, n, m, q])
        cn_vars = _peg_structure(n, m, dv_arr, rng)
        dc_max = max(len(x) for x in cn_vars)
        for val_try in range(8):
            vrng = np.random.default_rng([seed, attempt, val_try, 0xBEEF])
            chunk_w = None
            if weight_mode == "chunk8":
                chunk_w = vrng.integers(1, q, size=(-(-m // 8), dc_max)).astype(np.int32)
            row_cols, row_vals = [], []
            for mi in range(m):
                cols = np.array(sorted(cn_vars[mi]), dtype=np.int32)
                if chunk_w is not None:
                    vals = chunk_w[mi // 8, : len(cols)].copy()
                else:
                    vals = vrng.integers(1, q, size=len(cols)).astype(np.int32)
                row_cols.append(cols)
                row_vals.append(vals)
            spec = CodeSpec(q=q, n=n, m=m, row_cols=tuple(row_cols), row_vals=tuple(row_vals))
            if not require_full_rank or _full_rank(spec):
                return spec
    raise RuntimeError(f"could not build full-rank code ({n},{n - m}) over GF({q})")


def make_qc_code(
    n: int, m: int, q: int, z: int, dv: int = 2, seed: int = 0,
    require_full_rank: bool = True, weight_mode: str = "circulant",
) -> CodeSpec:
    """Quasi-cyclic NB-LDPC code: H is an (m/z) x (n/z) array of z x z
    circulant blocks (the identity shifted by a seeded exponent), built by
    the same degree-balanced PEG on the base graph. weight_mode
    "circulant": one seeded GF(q)* weight per circulant; "slot": one weight
    per sorted slot position, shared by every circulant in that position.
    """
    if n % z or m % z:
        raise ValueError(f"z={z} must divide n={n} and m={m}")
    nb, mb = n // z, m // z
    if mb < dv:
        raise ValueError("base graph needs at least dv check blocks")
    dv_arr = np.full(nb, dv, dtype=np.int64)
    for attempt in range(32):
        rng = np.random.default_rng([seed, attempt, n, m, q, z, 0x9C])
        base = _peg_structure(nb, mb, dv_arr, rng)
        for val_try in range(8):
            vrng = np.random.default_rng([seed, attempt, val_try, z, 0xC1])
            row_cols = [[] for _ in range(m)]
            row_vals = [[] for _ in range(m)]
            slot_w = [int(vrng.integers(1, q)) for _ in range(max(len(b) for b in base))]
            for bi in range(mb):
                for sj, bj in enumerate(sorted(base[bi])):
                    shift = int(vrng.integers(z))
                    w = slot_w[sj] if weight_mode == "slot" else int(vrng.integers(1, q))
                    for r in range(z):
                        row_cols[bi * z + r].append(bj * z + (r + shift) % z)
                        row_vals[bi * z + r].append(w)
            rc, rv = [], []
            for mi in range(m):
                order = np.argsort(row_cols[mi], kind="stable")
                rc.append(np.asarray(row_cols[mi], np.int32)[order])
                rv.append(np.asarray(row_vals[mi], np.int32)[order])
            spec = CodeSpec(q=q, n=n, m=m, row_cols=tuple(rc), row_vals=tuple(rv))
            if not require_full_rank or _full_rank(spec):
                return spec
    raise RuntimeError(f"could not build full-rank QC code ({n},{n - m}) over GF({q})")


# The BASELINE configurations' code shapes: name -> (n, m, q, dv, seed)
STANDARD_CODES = {
    "gf4_n96_k48": (96, 48, 4, 2, 1),
    "gf16_n204_k102": (204, 102, 16, 2, 1),
    "gf64_n576_k480": (576, 96, 64, 2, 1),
    "gf256_n255_k175": (255, 80, 256, 2, 1),
}

# Quasi-cyclic twins of two of them: name -> (n, m, q, z, dv, seed,
# weight_mode); "slot" where it reaches full rank (GF(16), z = 34),
# "circulant" with z = 8 for GF(4)
STANDARD_CODES_QC = {
    "gf4_n96_k48_qc": (96, 48, 4, 8, 2, 1, "circulant"),
    "gf16_n204_k102_qc": (204, 102, 16, 34, 2, 1, "slot"),
}

# chunk8 twins: the same PEG graphs as the standard codes, with one weight
# tuple per aligned 8-row group
STANDARD_CODES_C8 = {
    "gf4_n96_k48_c8": (96, 48, 4, 2, 1),
    "gf16_n204_k102_c8": (204, 102, 16, 2, 1),
}


def standard_names() -> tuple:
    """Every standard code's name, in the order gen-codes writes them."""
    return (*STANDARD_CODES, *STANDARD_CODES_C8, *STANDARD_CODES_QC)


def build_standard_code(name: str) -> CodeSpec:
    """The standard code `name` (KeyError for an unknown name)."""
    if name in STANDARD_CODES_QC:
        n, m, q, z, dv, seed, wm = STANDARD_CODES_QC[name]
        return make_qc_code(n, m, q, z, dv=dv, seed=seed, weight_mode=wm)
    if name in STANDARD_CODES_C8:
        n, m, q, dv, seed = STANDARD_CODES_C8[name]
        return make_peg_code(n, m, q, dv=dv, seed=seed, weight_mode="chunk8")
    n, m, q, dv, seed = STANDARD_CODES[name]
    return make_peg_code(n, m, q, dv=dv, seed=seed)
