"""The frozen bound arithmetic reproduces PERF.md's kernel table at its
shapes: K0 0.799 ms, K5 0.180 ms, route_down 0.2255 ms, and at config 5's
step (GF(256) (255,175): 510 edges in 80 checks of degree 6 and 7, 560
check slots) K0-cl 4.478 ms, route_down 1.659 ms, route_up 1.916 ms and
channel_llr 0.3292 ms."""

import pytest

from portbench import bounds, reference

FLAGSHIP = bounds.Shape(q=16, p=4, n=204, m=102, dc_max=4, dv_max=2, edges=408)


def test_k0_flagship_throughput_step():
    b = bounds.resident_qspa_bound(FLAGSHIP, 8192, 8192 * 50)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.799, abs=5e-4)


def test_k5_and_routing_at_config_4():
    g = bounds.shape_of(reference.load_code("gf64_n576_k480"))
    assert g == bounds.Shape(q=64, p=6, n=576, m=96, dc_max=12, dv_max=2, edges=1152)
    k5 = bounds.tems_cn_bound(g, 1024, 8)
    assert k5["bound_by"] == "bytes" and k5["bound_ms"] == pytest.approx(0.180, abs=5e-4)
    rb = bounds.route_bounds(g, 1024)
    assert rb["route_down"]["bound_ms"] == pytest.approx(0.2255, abs=5e-5)
    assert rb["route_up"]["bound_ms"] == pytest.approx(0.2705, abs=5e-5)


def test_channel_at_the_flagship_and_config_4():
    assert bounds.channel_bound(FLAGSHIP, 1, 8192)["bound_ms"] == pytest.approx(0.0399, abs=1e-4)
    g = bounds.shape_of(reference.load_code("gf64_n576_k480"))
    assert bounds.channel_bound(g, 1, 1024)["bound_ms"] == pytest.approx(0.0493, abs=1e-4)


def test_the_gf16_code_has_the_flagship_shape():
    assert bounds.shape_of(reference.load_code("gf16_n204_k102")) == FLAGSHIP


def test_config_5_code_has_its_true_edge_count_and_largest_degree():
    g = bounds.shape_of(reference.load_code("gf256_n255_k175"))
    assert g == bounds.Shape(q=256, p=8, n=255, m=80, dc_max=7, dv_max=2, edges=510)


def test_k0cl_routing_and_channel_at_config_5():
    g = bounds.shape_of(reference.load_code("gf256_n255_k175"))
    k0cl = bounds.resident_qspa_bound(g, 4096, 4096 * 20)
    assert k0cl["bound_by"] == "operations"
    assert k0cl["bound_ms"] == pytest.approx(4.478, abs=5e-4)
    rb = bounds.route_bounds(g, 4096)
    assert rb["route_down"]["bound_by"] == rb["route_up"]["bound_by"] == "bytes"
    assert rb["route_down"]["bound_ms"] == pytest.approx(1.659, abs=5e-4)
    assert rb["route_up"]["bound_ms"] == pytest.approx(1.916, abs=5e-4)
    ch = bounds.channel_bound(g, 8, 512)
    assert ch["bound_by"] == "bytes" and ch["bound_ms"] == pytest.approx(0.3292, abs=5e-5)
