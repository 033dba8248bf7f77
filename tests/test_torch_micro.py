"""The probes P1-P7 of the port (nbldpc_tpu_torch/kernels/micro.py and the
two entry points in nbldpc_tpu_torch/benchmarks/) against the JAX probe
scripts benchmarks/micro_pallas.py and benchmarks/micro_layout.py.

The scripts are not a package: they are loaded from their files, and their
module constants (shapes and depths, read when a kernel is traced) are set
small with monkeypatch. Inputs are made with numpy from a seed and go to
both sides. P1 and P2 do not run through pallas_call in this JAX (their
tables are captured constants), so their kernel bodies run eagerly with
numpy arrays as refs; P3 and P4 run with interpret=True; P5-P7 take no
interpret flag and run under force_tpu_interpret_mode(). On these CPU
tensors every wrapper runs its plain version.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbldpc_tpu_torch.benchmarks import micro_kernels, micro_layout
from nbldpc_tpu_torch.kernels import micro

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmp():
    return _load("micro_pallas")


@pytest.fixture(scope="module")
def jml():
    return _load("micro_layout")


def _set(monkeypatch, mod, **consts):
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)


def _jax_layout_tables(jml, seed=0):
    """micro_layout.main()'s numpy draws and one-hot operators, as it makes
    them (module constants as set)."""
    rng = np.random.default_rng(seed)
    dcm = jml.DC * jml.M
    vn = rng.integers(0, jml.N, size=dcm)
    wd = np.zeros((dcm, jml.N), np.float32)
    wd[np.arange(dcm), vn] = 1.0
    e_list = np.zeros((jml.DC, jml.N, jml.M), np.float32)
    for j in range(jml.DC):
        for m in range(jml.M):
            e_list[j, vn[j * jml.M + m], m] = 1.0
    rb_new = rng.integers(0, 2, size=(jml.ROT_BITS, jml.DC, jml.M, 1)).astype(np.float32)
    rb_old = rng.integers(0, 2, size=(jml.ROT_BITS, jml.DC, 1, jml.M)).astype(np.float32)
    return vn, wd, e_list, rb_new, rb_old


# --- input makers and converters ------------------------------------------

def test_make_inputs_match_jax_draws(jmp):
    x, perm = micro_kernels.make_inputs(0)
    jx, jperm = jmp.make_inputs(0)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(perm.numpy(), jperm)
    assert x.dtype == torch.float32 and perm.dtype == torch.int32
    # P2's tables as run_row_moves makes them
    pi, perms = micro.row_tables(perm, micro_kernels.Q)
    np.testing.assert_array_equal(pi.numpy(), jperm.reshape(-1, jmp.Q)[:, 0] // jmp.Q)
    np.testing.assert_array_equal(perms.numpy(), jperm.reshape(-1, jmp.Q) % jmp.Q)


def test_layout_inputs_and_converters_match_jax(jml):
    vn, wd, e_list, rb_new, rb_old = _jax_layout_tables(jml)
    inp = micro_layout.make_inputs(0)
    np.testing.assert_array_equal(inp["vn"].numpy(), vn)
    np.testing.assert_array_equal(inp["rb_new"].numpy(), rb_new)
    np.testing.assert_array_equal(inp["rb_old"].numpy(), rb_old)
    np.testing.assert_array_equal(micro.onehot_to_index(wd).numpy(), vn)
    np.testing.assert_array_equal(micro.elist_to_index(e_list).numpy(), vn)
    assert inp["post_new"].shape == (jml.Q, jml.N, jml.TB_NEW)
    assert inp["post_old"].shape == (jml.Q, jml.TB_OLD, jml.N)
    assert inp["x_new"].shape == (jml.Q, jml.DC, jml.M, jml.TB_NEW)
    assert inp["x_old"].shape == (jml.Q, jml.DC, jml.TB_OLD, jml.M)
    # the up-route table: each node's edges, ascending, padded with -1
    nbr = inp["nbr"].numpy()
    for n in range(jml.N):
        row = nbr[n][nbr[n] >= 0]
        np.testing.assert_array_equal(row, np.flatnonzero(vn == n))
        assert (nbr[n][len(row):] == -1).all()


def test_converters_reject_non_onehot():
    with pytest.raises(ValueError):
        micro.onehot_to_index(np.array([[1.0, 1.0], [0.0, 1.0]]))
    with pytest.raises(ValueError):
        micro.elist_to_index(np.zeros((2, 3, 4)))
    with pytest.raises(ValueError):
        micro.route_tables(np.array([0, 5]), 3)


def test_onehot_matrix_routes_like_perm():
    x, perm = micro_kernels.make_inputs(3, E=8, Q=4, BT=5)
    A = micro.onehot_matrix(perm)
    flat = x.reshape(32, 5)
    np.testing.assert_array_equal((A @ flat).numpy(), flat[perm.long()].numpy())


# --- P1-P4 against micro_pallas --------------------------------------------

SMALL = [(8, 4, 8, 3), (12, 16, 5, 2)]           # (E, Q, BT, ITERS)


@pytest.mark.parametrize("E,Q,BT,iters", SMALL)
def test_flat_gather_matches_jax_body(jmp, monkeypatch, E, Q, BT, iters):
    _set(monkeypatch, jmp, E=E, Q=Q, BT=BT, ITERS=iters)
    x, perm = micro_kernels.make_inputs(E, E=E, Q=Q, BT=BT)
    want = np.zeros((E, Q, BT), np.float32)
    jmp.flat_gather_kernel(x.numpy(), want, idx=perm.numpy())
    before = micro.flat_gather.launches
    got = micro.flat_gather(x, perm, iters)
    assert micro.flat_gather.launches == before         # a CPU tensor launches nothing
    np.testing.assert_array_equal(got.numpy(), want)     # gathers and +1: exact


@pytest.mark.parametrize("E,Q,BT,iters", SMALL)
def test_row_moves_matches_jax_body(jmp, monkeypatch, E, Q, BT, iters):
    _set(monkeypatch, jmp, E=E, Q=Q, BT=BT, ITERS=iters)
    x, perm = micro_kernels.make_inputs(E + 1, E=E, Q=Q, BT=BT)
    p = perm.numpy()
    pi_j = (p.reshape(E, Q)[:, 0] // Q).astype(np.int32)
    perms_j = (p.reshape(E, Q) % Q).astype(np.int32)
    want = np.zeros((E, Q, BT), np.float32)
    jmp.row_moves_kernel(x.numpy(), want, pi=pi_j, perms=perms_j)
    pi, perms = micro.row_tables(perm, Q)
    got = micro.row_moves(x, pi, perms, iters)
    np.testing.assert_array_equal(got.numpy(), want)     # exact


def test_onehot_gemm_matches_jax_run_matmul(jmp, monkeypatch):
    # run_matmul needs E Q >= 128 (its reshape guard)
    E, Q, BT, iters = 32, 4, 8, 3
    _set(monkeypatch, jmp, E=E, Q=Q, BT=BT, ITERS=iters)
    x, perm = micro_kernels.make_inputs(7, E=E, Q=Q, BT=BT)
    want = np.asarray(jmp.run_matmul(jnp.asarray(x.numpy()), perm.numpy(), interpret=True))
    got = micro.onehot_gemm(micro.onehot_matrix(perm), x, iters)
    # each output is one product x * 1 plus zeros: exact
    np.testing.assert_array_equal(got.numpy(), want)


def _spoil_a(A, value, row=3):
    A = A.clone()
    A[row, (int(A[row].argmax()) + 1) % A.shape[1]] = value
    return A


@pytest.mark.parametrize("spoil", [
    lambda A, x: (_spoil_a(A, 1.0), x),                  # two 1s in a row
    lambda A, x: (A * 2.0, x),                           # entries of 2
    lambda A, x: (A * 0.5, x),                           # entries of 0.5
    lambda A, x: (_spoil_a(A, float("nan")), x),
    lambda A, x: (A, x.index_fill(0, torch.tensor([1]), float("inf"))),
    lambda A, x: (A, x.index_fill(0, torch.tensor([1]), float("nan"))),
    lambda A, x: (A, x.index_fill(0, torch.tensor([1]), 1e-40)),       # subnormal
    lambda A, x: (A, x.index_fill(0, torch.tensor([1]), -(2.0 ** -110))),
], ids=["two_ones", "twos", "halves", "nan_in_a", "inf_x", "nan_x", "subnormal_x",
        "tiny_x"])
def test_onehot_gemm_rejects_what_the_split_cannot_hold(spoil):
    x, perm = micro_kernels.make_inputs(0, E=8, Q=4, BT=4)
    A, bad_x = spoil(micro.onehot_matrix(perm), x)
    with pytest.raises(ValueError, match="one-hot"):
        micro.onehot_gemm(A, bad_x, 1)


def test_onehot_gemm_takes_zero_rows_and_the_least_x():
    x, perm = micro_kernels.make_inputs(0, E=8, Q=4, BT=4)
    A = micro.onehot_matrix(perm)
    A[5] = 0.0                                           # a row of zeros routes 0
    x = x.index_fill(0, torch.tensor([2]), micro.ONEHOT_X_MIN)
    x[0, 0, 0] = 0.0
    out = micro.onehot_gemm(A, x, 2)
    assert torch.equal(out, micro.onehot_gemm_plain(A, x, 2))


@pytest.mark.parametrize("E,Q,BT,iters", [(8, 4, 8, 3), (16, 16, 4, 3), (8, 8, 6, 1)])
def test_cn_iteration_matches_jax_run_cn(jmp, monkeypatch, E, Q, BT, iters):
    _set(monkeypatch, jmp, E=E, Q=Q, BT=BT, ITERS=iters)
    x, perm = micro_kernels.make_inputs(9, E=E, Q=Q, BT=BT)
    want = np.asarray(jmp.run_cn(jnp.asarray(x.numpy()), perm.numpy(), interpret=True))
    got = micro.cn_iteration(x, iters).numpy()
    # the port sums over q left to right, XLA in its own order, which may
    # round the normalization an ulp apart (bit-equal here); outputs <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- P5-P7 against micro_layout ---------------------------------------------

@pytest.mark.parametrize("layout", ["new", "old"])
def test_rot_softmax_matches_jax_make_elem(jml, layout):
    Q, DC, M, TB, iters = jml.Q, 4, 6, 8, 3
    rng = np.random.default_rng(11)
    shape = (Q, DC, M, TB) if layout == "new" else (Q, DC, TB, M)
    rb_shape = (jml.ROT_BITS, DC, M, 1) if layout == "new" else (jml.ROT_BITS, DC, 1, M)
    x = (rng.standard_normal(shape) - 1.0).astype(np.float32)
    rb = rng.integers(0, 2, size=rb_shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jml.make_elem(shape, rb_shape, iters)(jnp.asarray(x),
                                                               jnp.asarray(rb)))
    got = micro.rot_softmax(torch.from_numpy(x), torch.from_numpy(rb), iters, layout)
    # exp and the softmax sum's order may differ by an ulp; values in [-0.5, 0.5]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _p5_inputs(Q, layout, seed, DC=3, M=5, TB=7):
    """P5's X with -0.0, +0.0, +-inf, NaN and values whose exp overflows
    among normal draws, and a random RB of 0s and 1s (one entry -0.0)."""
    rng = np.random.default_rng(seed)
    shape = (Q, DC, M, TB) if layout == "new" else (Q, DC, TB, M)
    rb_shape = (micro.ROT_BITS, DC, M, 1) if layout == "new" else (micro.ROT_BITS, DC, 1, M)
    x = torch.from_numpy((rng.standard_normal(shape) * 30).astype(np.float32))
    flat = x.view(-1)
    flat[::7], flat[::11] = -0.0, 0.0
    flat[3], flat[5], flat[9] = float("inf"), -float("inf"), float("nan")
    rb = torch.from_numpy(rng.integers(0, 2, size=rb_shape).astype(np.float32))
    rb.view(-1)[4] = -0.0
    return x, rb


def _same_bits(a, b) -> bool:
    """Equal NaN positions and, elsewhere, equal values with equal signs."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
            and torch.equal(a[~nan].signbit(), b[~nan].signbit()))


@pytest.mark.parametrize("layout", ["new", "old"])
@pytest.mark.parametrize("Q", [2, 4, 8, 16, 32])
def test_rot_softmax_rolled_equals_plain(Q, layout):
    """P5's scheme on the card (the blend in iteration 0, then one roll a
    column) equals the plain version bit for bit, NaN where it has NaN,
    with signed zeros, infinities and NaN in X and a 0.5 in RB."""
    x, rb = _p5_inputs(Q, layout, Q)
    rb.view(-1)[2] = 0.5
    for iters in (0, 1, 2, 3, 50):
        want = micro.rot_softmax_plain(x, rb, iters)
        assert _same_bits(micro.rot_softmax_rolled(x, rb, iters), want)
        assert _same_bits(micro.rot_softmax(x, rb, iters, layout), want)


@pytest.mark.parametrize("Q", [2, 4, 8, 16, 32])
def test_rot_amounts_compose_the_bits(Q):
    """The host twin of the kernel's roll: r = sum_t b_t (2^t mod L) mod L
    equals the four rolls of the blend applied one after another."""
    L = Q - 1
    rb = torch.tensor([[b >> t & 1 for b in range(16)] for t in range(micro.ROT_BITS)],
                      dtype=torch.float32).view(micro.ROT_BITS, 1, 16, 1)
    r, flat = micro.rot_amounts(rb, Q)
    assert bool(flat.all()) and r.shape == (1, 16, 1)
    z = torch.arange(L, dtype=torch.float32)
    for b in range(16):
        want = z
        for t in range(micro.ROT_BITS):
            if b >> t & 1:
                s = (1 << t) % L
                want = torch.cat([want[L - s:], want[:L - s]])
        assert torch.equal(torch.roll(z, int(r[0, b, 0])), want)


def test_rot_amounts_flag_other_entries_to_the_blend():
    """A column with an RB entry other than 0 or 1 (0.5 here, or NaN) is
    not flat: the kernel blends it every iteration; -0.0 counts as 0."""
    rb = torch.zeros((micro.ROT_BITS, 1, 4, 1))
    rb[1, 0, 0] = 0.5
    rb[2, 0, 1] = float("nan")
    rb[0, 0, 2] = -0.0
    rb[3, 0, 3] = 1.0
    r, flat = micro.rot_amounts(rb, 16)
    assert flat.view(-1).tolist() == [False, False, True, True]
    assert r.view(-1).tolist() == [0, 0, 0, 8]


SMALL_ROUTE = dict(Q=4, DC=4, M=6, N=12, TB_NEW=8, TB_OLD=8)


def _route_inputs(jml):
    vn, wd, e_list, _, _ = _jax_layout_tables(jml, seed=2)
    rng = np.random.default_rng(3)
    post_new = rng.standard_normal((jml.Q, jml.N, jml.TB_NEW)).astype(np.float32)
    post_old = rng.standard_normal((jml.Q, jml.TB_OLD, jml.N)).astype(np.float32)
    return vn, wd, e_list, post_new, post_old


@pytest.mark.parametrize("variant", ["r3_id", "r3_tr", "rep"])
def test_route_new_matches_each_jax_variant(jml, monkeypatch, variant):
    _set(monkeypatch, jml, **SMALL_ROUTE)
    vn, wd, _, post, _ = _route_inputs(jml)
    assert np.bincount(vn, minlength=jml.N).max() >= 3
    iters = 3
    wrep = jnp.asarray(np.broadcast_to(wd[None], (jml.Q,) + wd.shape).copy())
    iq = jnp.asarray(np.eye(jml.Q, dtype=np.float32))
    with pltpu.force_tpu_interpret_mode():
        run, _ = jml.make_route(variant, iters, jnp.asarray(wd), wrep, iq)
        want = np.asarray(run(jnp.asarray(post)))
    vn_t = micro.onehot_to_index(wd)
    got = micro.route(torch.from_numpy(post), vn_t, micro.route_tables(vn_t, jml.N), iters,
                      "new")
    # every term of node n is a copy of 0.999 post[n]; XLA's dot may add
    # four or more equal copies in another order than the port's ascending sum
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_route_old_matches_jax_make_route_old(jml, monkeypatch):
    _set(monkeypatch, jml, **SMALL_ROUTE)
    vn, _, e_list, _, post = _route_inputs(jml)
    iters = 3
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jml.make_route_old(iters, jnp.asarray(e_list))(jnp.asarray(post)))
    vn_t = micro.elist_to_index(e_list)
    got = micro.route(torch.from_numpy(post), vn_t, micro.route_tables(vn_t, jml.N), iters,
                      "old")
    assert got.shape == post.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_route_layouts_agree():
    """P6 and P7 compute one function: the old layout is the new one with
    its last two axes swapped, and the sums are the same, so it is exact."""
    inp = micro_layout.make_inputs(0, N=20, M=10, TB_NEW=6)
    post = inp["post_new"]
    new = micro.route(post, inp["vn"], inp["nbr"], 4, "new")
    old = micro.route(post.transpose(1, 2).contiguous(), inp["vn"], inp["nbr"], 4, "old")
    assert torch.equal(old, new.transpose(1, 2))


# --- P2's slot order (the host twin of what csrc/micro_gather.cu builds) -----

def _round_wavefronts(addr):
    """Shared-memory wavefronts of each round (32 consecutive slots): the
    most distinct addresses in one bank; pad slots (-1) aside."""
    out = []
    for row in np.asarray(addr).reshape(-1, 32):
        a = np.unique(row[row >= 0])
        out.append(int(np.bincount(a % 32, minlength=32).max()) if a.size else 0)
    return np.asarray(out)


@pytest.mark.parametrize("E", [1, 37, 408])
def test_row_schedule_pairs_edges_by_parity(E):
    """At Q = 16: every row in one slot, each half-warp one edge's 16 rows
    in slot order, and every round free of bank conflicts on its gathers
    and its stores but those of pairs left over by the class counts."""
    perm = np.random.default_rng(E).permutation(E * 16)
    pi, perms = (t.numpy() for t in micro.row_tables(perm, 16))
    s = micro.row_schedule(pi, 16)
    assert s.size == 32 * -(-E // 2)
    assert np.array_equal(np.sort(s[s >= 0]), np.arange(E * 16))
    halves = s.reshape(-1, 16)
    assert np.all((halves < 0).all(1) | (halves == halves[:, :1] + np.arange(16)).all(1))
    e, q = np.maximum(s, 0) // 16, np.maximum(s, 0) % 16
    src = np.where(s >= 0, pi[e] * 16 + perms[e, q], -1)
    n = np.bincount(2 * (np.arange(E) % 2) + pi % 2, minlength=4)
    left_pairs = -(-(abs(n[0] - n[3]) + abs(n[1] - n[2])) // 2)
    assert ((_round_wavefronts(src) > 1) | (_round_wavefronts(s) > 1)).sum() <= left_pairs
    assert np.array_equal(micro.row_schedule(np.zeros(5), 3), np.arange(15))  # other Q: in order


# --- wrapper checks ----------------------------------------------------------

def test_wrappers_reject_bad_input():
    x, perm = micro_kernels.make_inputs(0, E=8, Q=4, BT=4)
    pi, perms = micro.row_tables(perm, 4)
    bad_x = [x.double(), x.transpose(0, 2), x[:, :, 0]]
    for bx in bad_x:
        with pytest.raises(ValueError):
            micro.flat_gather(bx, perm, 1)
        with pytest.raises(ValueError):
            micro.row_moves(bx, pi, perms, 1)
        with pytest.raises(ValueError):
            micro.cn_iteration(bx, 1)
    with pytest.raises(ValueError):
        micro.flat_gather(x, perm.long(), 1)                 # table dtype
    with pytest.raises(ValueError):
        micro.flat_gather(x, perm[:-1], 1)                   # table length
    with pytest.raises(ValueError):
        micro.flat_gather(x, perm, -1)
    with pytest.raises(ValueError):
        micro.row_moves(x, pi[:-1], perms, 1)
    with pytest.raises(ValueError):
        micro.onehot_gemm(micro.onehot_matrix(perm)[:, :-1], x, 1)
    with pytest.raises(ValueError):
        micro.onehot_gemm(micro.onehot_matrix(perm).double(), x, 1)
    with pytest.raises(ValueError):
        micro.cn_iteration(torch.zeros((6, 4, 2)), 1)         # E not a multiple of 4
    with pytest.raises(ValueError):
        micro.cn_iteration(torch.zeros((8, 6, 2)), 1)         # Q not a power of 2
    inp = micro_layout.make_inputs(0, Q=4, M=5, N=10, TB_NEW=3, TB_OLD=2)
    for layout, other in (("new", "old"), ("old", "new")):
        with pytest.raises(ValueError):
            micro.rot_softmax(inp[f"x_{layout}"], inp[f"rb_{other}"], 1, layout)
        with pytest.raises(ValueError):
            micro.rot_softmax(inp[f"x_{layout}"].double(), inp[f"rb_{layout}"], 1, layout)
        with pytest.raises(ValueError):
            micro.route(inp[f"post_{layout}"], inp["vn"], inp["nbr"][:-1], 1, layout)
        with pytest.raises(ValueError):
            micro.route(inp[f"post_{layout}"], inp["vn"].long(), inp["nbr"], 1, layout)
    with pytest.raises(ValueError):
        micro.rot_softmax(inp["x_new"], inp["rb_new"], 1, "sideways")
    with pytest.raises(ValueError):
        micro.route(inp["post_new"], inp["vn"], inp["nbr"], 1, "sideways")


# --- the port imports no JAX; the entry points ------------------------------

def test_probe_modules_import_without_jax():
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'nbldpc_tpu'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
for m in ('nbldpc_tpu_torch.kernels.micro', 'nbldpc_tpu_torch.benchmarks.micro_kernels',
          'nbldpc_tpu_torch.benchmarks.micro_layout'):
    importlib.import_module(m)
bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'nbldpc_tpu')]
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_micro_kernels_main_on_cpu(capsys):
    assert micro_kernels.main(["--only", "gather", "--reps", "1", "--device", "cpu"]) == 0
    assert micro_kernels.main(["--only", "row_moves", "--reps", "1", "--device", "cpu"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["case"] for r in rows] == ["flat_constant_gather", "per_edge_row_moves"]
    for r in rows:
        assert r["device"] == "cpu" and "card" not in r
        assert r["ms_per_call"] > 0 and r["us_per_iter"] == pytest.approx(
            r["ms_per_call"] / micro_kernels.ITERS * 1e3)


def test_micro_layout_main_on_cpu(capsys):
    assert micro_layout.main(["--iters", "1", "--reps", "1", "--device", "cpu"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["case"] for r in rows] == list(micro_layout.NAMES)
    for r in rows:
        assert r["device"] == "cpu" and r["iters"] == [1, 4]
        assert {"ms_low", "ms_high", "us_per_iter", "ns_per_frame_iter"} <= set(r)


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the default without one")
    for main in (micro_kernels.main, micro_layout.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--only", "route_new"])
