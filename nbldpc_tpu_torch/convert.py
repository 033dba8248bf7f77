"""State carried across from the JAX package, as plain numpy arrays.

    spec  = codespec_from_arrays(js.q, js.n, js.m, js.row_cols, js.row_vals)
    t     = graph_tables_from_numpy({"cn_vn": jg.cn_vn_np,
                                     "down_idx": np.asarray(jg.down_idx), ...},
                                    "cpu")
    graph = TannerGraph(spec, "cpu", tables=t)

Checkpoints need no conversion: the port's Checkpointer reads the JAX
package's files (same format, same config hash).
"""

from __future__ import annotations

import numpy as np
import torch

from nbldpc_tpu_torch.code import CodeSpec
from nbldpc_tpu_torch.graph import TABLE_NAMES

_DTYPES = {"cn_mask": bool, "vn_mask": bool}


def codespec_from_arrays(q, n, m, row_cols, row_vals) -> CodeSpec:
    """The port's CodeSpec from the JAX CodeSpec's fields."""
    spec = CodeSpec(
        q=int(q), n=int(n), m=int(m),
        row_cols=tuple(np.asarray(c, dtype=np.int32) for c in row_cols),
        row_vals=tuple(np.asarray(v, dtype=np.int32) for v in row_vals),
    )
    spec.validate()
    return spec


def graph_tables_from_numpy(d: dict, device) -> dict:
    """Graph-table tensors from a JAX TannerGraph's tables as numpy arrays.

    Keys are graph.TABLE_NAMES (a missing key raises); values are cast to
    the port's dtypes (bool masks, int32 indices)."""
    missing = [k for k in TABLE_NAMES if k not in d]
    if missing:
        raise KeyError(f"missing graph tables: {missing}")
    return {
        k: torch.from_numpy(np.ascontiguousarray(
            np.asarray(d[k]).astype(_DTYPES.get(k, np.int32)))).to(device)
        for k in TABLE_NAMES
    }
