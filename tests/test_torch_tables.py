"""The port's GF and Tanner-graph tables equal the JAX package's bit for bit,
for every checked-in code, built directly and through convert.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

import nbldpc_tpu.code as jcode
import nbldpc_tpu.gf as jgf
import nbldpc_tpu.graph as jgraph

from nbldpc_tpu_torch import convert
from nbldpc_tpu_torch import gf as tgf
from nbldpc_tpu_torch.code import load_alist, save_alist
from nbldpc_tpu_torch.graph import TABLE_NAMES, TannerGraph

torch.set_num_threads(1)

CODES = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "codes").glob("*.alist"))
CODE_DIR = Path(__file__).resolve().parents[1] / "codes"


def jax_tables(g) -> dict:
    """The JAX TannerGraph's tables as numpy, under the port's names."""
    return {
        "cn_vn": g.cn_vn_np, "cn_w": g.cn_w_np, "cn_mask": g.cn_mask_np,
        "vn_edge": g.vn_edge_np, "vn_mask": g.vn_mask_np,
        "cn_slot_of_vn_slot": np.asarray(g.cn_slot_of_vn_slot),
        "perm_down": np.asarray(g.perm_down), "perm_up": np.asarray(g.perm_up),
        "down_idx": np.asarray(g.down_idx), "up_idx": np.asarray(g.up_idx),
        "syn_k": np.asarray(g.syn_k),
    }


def assert_tables_equal(tg: TannerGraph, ref: dict):
    for name in TABLE_NAMES:
        got = getattr(tg, name).numpy()
        assert got.dtype == (np.bool_ if name.endswith("mask") else np.int32), name
        np.testing.assert_array_equal(got, ref[name], err_msg=name)
    assert (tg.q, tg.n, tg.m, tg.dc_max, tg.dv_max) == (
        len(ref["perm_down"][0, 0]), ref["vn_edge"].shape[0], ref["cn_vn"].shape[0],
        ref["cn_vn"].shape[1], ref["vn_edge"].shape[1])


@pytest.mark.parametrize("q", [2, 4, 8, 16, 32, 64, 128, 256])
def test_gf_tables_equal(q):
    a, b = tgf.GF(q), jgf.GF(q)
    assert tgf.PRIM_POLY[q] == jgf.PRIM_POLY[q]
    for name in ("exp", "log", "mul", "inv", "bits"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert getattr(a, name).dtype == getattr(b, name).dtype
    assert a.p == b.p


@pytest.mark.parametrize("code", CODES)
def test_graph_tables_equal(code, tmp_path):
    path = CODE_DIR / f"{code}.alist"
    js, ts = jcode.load_alist(path), load_alist(path)
    assert (ts.q, ts.n, ts.m) == (js.q, js.n, js.m)
    for a, b in zip(ts.row_cols + ts.row_vals, js.row_cols + js.row_vals):
        np.testing.assert_array_equal(a, b)
    ref = jax_tables(jgraph.TannerGraph(js))
    assert_tables_equal(TannerGraph(ts, "cpu"), ref)

    # through convert.py: the JAX spec's arrays and the JAX graph's tables
    cs = convert.codespec_from_arrays(js.q, js.n, js.m, js.row_cols, js.row_vals)
    tg = TannerGraph(cs, "cpu", tables=convert.graph_tables_from_numpy(ref, "cpu"))
    assert_tables_equal(tg, ref)
    assert (tg.has_cn_pads, tg.has_vn_pads) == (
        jgraph.TannerGraph(js).has_cn_pads, jgraph.TannerGraph(js).has_vn_pads)

    # alist round trip through the port's writer reads back in the JAX reader
    save_alist(ts, tmp_path / "c.alist")
    back = jcode.load_alist(tmp_path / "c.alist")
    np.testing.assert_array_equal(back.dense_h(), js.dense_h())


def test_convert_rejects_missing_tables():
    with pytest.raises(KeyError, match="missing graph tables"):
        convert.graph_tables_from_numpy({"cn_vn": np.zeros((1, 1), np.int32)}, "cpu")
