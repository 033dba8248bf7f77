"""Plain reference of one Monte-Carlo sweep step: noise, channel, decode,
error counters.

Written from the textbook equations and the sweep's documented
conventions, in plain PyTorch and numpy only: it imports nothing of the
program (nor JAX), and takes nothing the program made. It parses the code
from its own copy of the alist file (portbench/codes/), builds GF(2^p)
from the field's primitive polynomial, and redraws each step's noise
from (seed, step index) by the sweep's documented rule.

  noise    a torch.Generator on the device seeded from
           np.random.SeedSequence([seed, t]).generate_state(1, uint64)[0],
           one torch.randn of shape [S, B, N, p];
  channel  the all-zero codeword, BPSK bit 0 -> +1, y = 1 + sigma n,
           llr[a] = -(2 / sigma^2) sum_i y_i bit_i(a), bits LSB first,
           sigma^2 = 1 / (2 R 10^(Eb/N0 / 10));
  decode   flooding BP: v -> c messages V = posterior - C (normalized, max
           0), permuted into the check's x = h c domain; the check update,
           on the checks of each degree together as one tensor
           (QSPA: the xor-convolution of the other edges' pmfs through the
           Walsh-Hadamard transform, floored at 1e-12, then the log;
           T-EMS: the best path of at most two deviations from the
           most reliable symbols, the first deviation among the n_r most
           reliable rows, plus the offset, clipped at 0); C back in the
           variable's domain; posterior = prior + the sum of C; decision
           argmax (lowest symbol on ties) and syndrome. A frame's outputs
           freeze at the first iteration whose decision satisfies H
           (iters counts the iterations it ran until then);
  counters frames, frame errors, symbol errors, bit errors, the sum of
           iterations and the frames done, per SNR slot.

`dtype` is the precision of the whole decode (float32 as the configuration
states; bfloat16 for the control). Frames that are done leave the batch,
so only the frames still decoding are computed.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

COUNTERS = ("frames", "frame_errors", "symbol_errors", "bit_errors", "iter_sum", "converged")
PRIM_POLY = {2: 0b11, 4: 0b111, 8: 0b1011, 16: 0b10011, 32: 0b100101,
             64: 0b1000011, 128: 0b10001001, 256: 0b100011101}
PROB_FLOOR = 1e-12
NEG = -1e30
CODES_DIR = Path(__file__).resolve().parent / "codes"


def field_tables(q: int) -> tuple:
    """(mul [q, q], inv [q]) of GF(q) = GF(2)[x] / PRIM_POLY[q] (numpy int64)."""
    poly, exp, log = PRIM_POLY[q], np.zeros(q - 1, np.int64), np.zeros(q, np.int64)
    x = 1
    for i in range(q - 1):
        exp[i], log[x] = x, i
        x <<= 1
        if x & q:
            x ^= poly
    a = np.arange(q)
    mul = exp[(log[a][:, None] + log[a][None, :]) % (q - 1)]
    mul[0, :] = 0
    mul[:, 0] = 0
    inv = np.zeros(q, np.int64)
    inv[1:] = exp[(q - 1 - log[1:]) % (q - 1)]
    return mul, inv


@dataclasses.dataclass
class Code:
    """A parity-check code over GF(q) with a regular variable degree and
    checks of any degree: the edges in check-major order (check m's edges
    are edge_start[m] .. edge_start[m] + check_deg[m] - 1, in the row's
    order)."""

    q: int
    n: int
    m: int
    dv: int
    check_deg: np.ndarray     # [M] degree of each check
    edge_var: np.ndarray      # [E] variable of each edge
    edge_w: np.ndarray        # [E] GF weight h of each edge
    var_edges: np.ndarray     # [N, dv] each variable's edges, in check order

    @property
    def p(self) -> int:
        return self.q.bit_length() - 1

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def dc_max(self) -> int:
        return int(self.check_deg.max())

    @property
    def edges(self) -> int:
        return int(self.check_deg.sum())

    @property
    def edge_start(self) -> np.ndarray:
        return np.concatenate(([0], np.cumsum(self.check_deg)[:-1])).astype(np.int64)

    def degree_groups(self) -> list:
        """For each check degree d, ascending, the edges [M_d, d] of the
        checks of degree d, a row a check in check order."""
        start = self.edge_start
        return [start[self.check_deg == d][:, None] + np.arange(d)
                for d in np.unique(self.check_deg)]


def load_code(name: str, codes_dir: Path = CODES_DIR) -> Code:
    """Parse codes_dir/<name>.alist: "N M q", the degree maxima, the column
    and row degrees, N column lines, then M row lines of "col value" pairs
    (1-based)."""
    lines = [ln for ln in (codes_dir / f"{name}.alist").read_text().splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    n, m, q = (int(x) for x in lines[0].split())
    check_deg = np.asarray([int(x) for x in lines[3].split()], np.int64)
    if len(check_deg) != m:
        raise ValueError(f"{name}: {len(check_deg)} row degrees, expected {m}")
    edge_var, edge_w = [], []
    for i, row in enumerate(lines[4 + n:4 + n + m]):
        nums = [int(x) for x in row.split()]
        if len(nums) != 2 * check_deg[i]:
            raise ValueError(f"{name}: row {i} has {len(nums) // 2} entries, "
                             f"expected {check_deg[i]}")
        edge_var += [c - 1 for c in nums[0::2]]
        edge_w += nums[1::2]
    edge_var = np.asarray(edge_var, np.int64)
    dv_count = np.bincount(edge_var, minlength=n)
    if len(set(dv_count.tolist())) != 1:
        raise ValueError(f"{name}: the reference takes a regular variable degree only")
    var_edges = np.argsort(edge_var, kind="stable").reshape(n, int(dv_count[0]))
    return Code(q=q, n=n, m=m, dv=int(dv_count[0]), check_deg=check_deg, edge_var=edge_var,
                edge_w=np.asarray(edge_w, np.int64), var_edges=var_edges)


def ebn0_to_sigma(ebn0_db: float, rate: float) -> float:
    return float(np.sqrt(1.0 / (2.0 * rate * 10.0 ** (ebn0_db / 10.0))))


def step_noise(seed: int, t: int, shape: tuple, device) -> torch.Tensor:
    """The noise of sweep step t: [S, B, N, p] standard normals."""
    s = np.random.SeedSequence([int(seed), int(t)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s))
    return torch.randn(shape, generator=gen, device=device)


def channel_llr(noise: torch.Tensor, sigmas, q: int) -> torch.Tensor:
    """noise [S, B, N, p] -> llr [S, B, N, q] f32 of the all-zero codeword."""
    p = q.bit_length() - 1
    sig = torch.as_tensor(np.asarray(sigmas, np.float32), device=noise.device)
    sig = sig[:, None, None, None]
    y = 1.0 + sig * noise
    bits = torch.as_tensor((np.arange(q)[:, None] >> np.arange(p)[None, :]) & 1,
                           dtype=torch.float32, device=noise.device)        # [q, p]
    acc = (y[..., None, :] * bits).sum(dim=-1)                              # [S,B,N,q]
    return -(2.0 / sig ** 2) * acc


class Decoder:
    """The batched reference decoder of one code on one device."""

    def __init__(self, code: Code, device, kind: str, max_iters: int, offset: float = 0.0,
                 n_r: int = 0, dtype=torch.float32):
        if kind not in ("qspa", "tems"):
            raise ValueError(f"the reference decodes qspa and tems, not {kind!r}")
        self.code, self.kind, self.max_iters = code, kind, max_iters
        self.offset, self.dtype, self.device = offset, dtype, torch.device(device)
        self.n_r = n_r if n_r else code.q - 1     # n_r = 0: every row, the exact scan
        q = code.q
        mul, inv = field_tables(q)
        a = np.arange(q)
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=self.device)
        self.mul = t(mul.reshape(-1))                                  # [q*q]
        self.down = t(mul[inv[code.edge_w][:, None], a[None, :]])      # U(x) = V(h^-1 x)
        self.up = t(mul[code.edge_w[:, None], a[None, :]])             # C(c) = Chat(h c)
        self.edge_var = t(code.edge_var)
        self.edge_w = t(code.edge_w)
        self.var_edges = t(code.var_edges)
        self.iota = torch.arange(q, device=self.device)
        groups = code.degree_groups()
        # a code of one check degree is one view of the edges; otherwise each
        # degree's edges are gathered, decoded and scattered back
        self.groups = None if len(groups) == 1 else [t(idx) for idx in groups]

    def by_degree(self, x: torch.Tensor) -> list:
        """x [A, E, ...] -> its edges of each check degree, [A, M_d, d, ...]."""
        if self.groups is None:
            return [x.view(x.shape[0], self.code.m, self.code.dc_max, *x.shape[2:])]
        return [x[:, idx] for idx in self.groups]

    def syndrome_ok(self, hard: torch.Tensor) -> torch.Tensor:
        """hard [A, N] -> [A] bool: every check sums to 0 over GF(q)."""
        c = self.code
        prod = self.mul[self.edge_w * c.q + hard[:, self.edge_var].long()]
        sums = []
        for g in self.by_degree(prod):
            s = g[:, :, 0]
            for j in range(1, g.shape[2]):
                s = s ^ g[:, :, j]
            sums.append(s)
        return (torch.cat(sums, dim=1) == 0).all(dim=1)

    def decode(self, llr: torch.Tensor) -> tuple:
        """llr [B, N, q] -> (hard [B, N] int64, done [B] bool, iters [B] int64)."""
        c = self.code
        prior = llr.to(self.dtype)
        prior = prior - prior.amax(dim=-1, keepdim=True)
        hard = prior.argmax(dim=-1)
        done = self.syndrome_ok(hard)
        iters = torch.zeros(llr.shape[0], dtype=torch.int64, device=llr.device)
        act = torch.nonzero(~done).flatten()
        pri = prior[act]
        C = torch.zeros((act.numel(), c.edges, c.q), dtype=self.dtype, device=llr.device)
        post = pri
        for _ in range(self.max_iters):
            if act.numel() == 0:
                break
            V = post[:, self.edge_var] - C                              # [A, E, q]
            V = V - V.amax(dim=-1, keepdim=True)
            U = torch.gather(V, 2, self.down.expand_as(V))              # x-domain
            Chat = self.checks(U)
            C = torch.gather(Chat, 2, self.up.expand_as(Chat))          # c-domain
            Cs = C[:, self.var_edges]                                   # [A, N, dv, q]
            acc = Cs[:, :, 0]
            for k in range(1, c.dv):
                acc = acc + Cs[:, :, k]
            post = pri + acc
            h = post.argmax(dim=-1)
            ok = self.syndrome_ok(h)
            iters[act] += 1
            hard[act] = h
            done[act] = ok
            keep = torch.nonzero(~ok).flatten()
            act, pri, C, post = act[keep], pri[keep], C[keep], post[keep]
        return hard, done, iters

    def checks(self, U: torch.Tensor) -> torch.Tensor:
        """U [A, E, q] -> Chat [A, E, q]: each degree's checks updated as one
        [A, M_d, d, q] tensor, their outputs put back on their edges."""
        if self.groups is None:
            return self.check(self.by_degree(U)[0]).view_as(U)
        Chat = torch.empty_like(U)
        for idx, g in zip(self.groups, self.by_degree(U)):
            Chat[:, idx] = self.check(g)
        return Chat

    def check(self, U: torch.Tensor) -> torch.Tensor:
        """U [A, M, dc, q] (x-domain, max 0 over q) -> Chat, the same shape."""
        return self.check_qspa(U) if self.kind == "qspa" else self.check_tems(U)

    def wht(self, x: torch.Tensor) -> torch.Tensor:
        """Unnormalized Walsh-Hadamard transform along the last axis."""
        q = x.shape[-1]
        lead = x.shape[:-1]
        h = 1
        while h < q:
            y = x.reshape(*lead, q // (2 * h), 2, h)
            a, b = y[..., 0, :], y[..., 1, :]
            x = torch.stack((a + b, a - b), dim=-2).reshape(*lead, q)
            h *= 2
        return x

    def check_qspa(self, U: torch.Tensor) -> torch.Tensor:
        """Each edge's pmf is the xor-convolution of the other dc - 1 edges':
        the product of their spectra, transformed back."""
        P = torch.softmax(U, dim=-1)
        F = self.wht(P)
        dc = F.shape[2]
        pre = [torch.ones_like(F[:, :, 0])]
        for j in range(dc - 1):
            pre.append(pre[-1] * F[:, :, j])
        suf = [torch.ones_like(F[:, :, 0])]
        for j in range(dc - 1, 0, -1):
            suf.append(suf[-1] * F[:, :, j])
        G = torch.stack([pre[j] * suf[dc - 1 - j] for j in range(dc)], dim=2)
        Q = torch.clamp_min(self.wht(G) / F.shape[-1], PROB_FLOOR)
        Chat = torch.log(Q)
        return Chat - Chat.amax(dim=-1, keepdim=True)

    def check_tems(self, U: torch.Tensor) -> torch.Tensor:
        """dW_j(eta): the best of one deviation (the best row eta over the
        other columns) and two deviations e1 ^ e2 = eta (e1 among the n_r
        best rows, both nonzero; where both bests lie in one column, the
        second best replaces one side); C_j(a) = dW_j(a ^ beta ^ z_j)."""
        A, M, dc, q = U.shape
        iota = self.iota
        z = U.argmax(dim=-1)                                            # [A, M, dc]
        dU = torch.gather(U, 3, iota ^ z[..., None])                    # deviations
        beta = z[:, :, 0]
        for j in range(1, dc):
            beta = beta ^ z[:, :, j]
        vals, cols = torch.sort(dU.transpose(2, 3), dim=-1, descending=True, stable=True)
        m1, m2, m3 = (vals[..., i][:, :, None, :] for i in range(3))    # [A, M, 1, q]
        c1, c2 = (cols[..., i][:, :, None, :] for i in range(2))
        jcol = torch.arange(dc, device=U.device).view(1, 1, dc, 1)
        m1x = torch.where(c1 == jcol, m2, m1)                           # [A, M, dc, q]
        c1x = torch.where(c1 == jcol, c2, c1)
        m2x = torch.where((c1 == jcol) | (c2 == jcol), m3, m2)
        _, order = torch.sort(m1x[..., 1:], dim=-1, descending=True, stable=True)
        picks = order[..., :self.n_r] + 1
        dw = m1x
        for r in range(self.n_r):
            e1 = picks[..., r:r + 1]
            v1, v2 = torch.gather(m1x, 3, e1), torch.gather(m2x, 3, e1)
            ce = torch.gather(c1x, 3, e1)
            cand = torch.where(ce == c1x, torch.maximum(v1 + m2x, v2 + m1x), v1 + m1x)
            cand = torch.where(iota == 0, NEG, cand)                    # e2 != 0
            dw = torch.maximum(dw, torch.gather(cand, 3, (iota ^ e1).expand_as(cand)))
        dw = torch.where(iota == 0, 0.0, dw)
        Chat = torch.gather(dw, 3, iota ^ (beta[:, :, None, None] ^ z[..., None]))
        return torch.clamp_max(Chat - Chat.amax(dim=-1, keepdim=True) + self.offset, 0.0)


def counters(hard: torch.Tensor, done: torch.Tensor, iters: torch.Tensor, S: int,
             p: int) -> np.ndarray:
    """The step's counters [6, S] (COUNTERS order) of the all-zero codeword."""
    h = hard.view(S, -1, hard.shape[-1]).long()
    err = h != 0
    bits = sum((h >> t) & 1 for t in range(p))
    out = torch.stack([
        torch.full((S,), h.shape[1], dtype=torch.int64, device=h.device),
        err.any(dim=-1).sum(dim=1),
        err.sum(dim=(1, 2)),
        bits.sum(dim=(1, 2)),
        iters.view(S, -1).sum(dim=1),
        done.view(S, -1).sum(dim=1),
    ])
    return out.cpu().numpy().astype(np.int64)


def step_counters(code: Code, decoder: Decoder, seed: int, t: int, ebn0_db, B: int,
                  block: int) -> np.ndarray:
    """The reference's counters [6, S] of sweep step t (its generator index),
    decoding `block` frames at a time."""
    S = len(ebn0_db)
    sig = [np.float32(ebn0_to_sigma(e, code.k / code.n)) for e in ebn0_db]
    noise = step_noise(seed, t, (S, B, code.n, code.p), decoder.device)
    llr = channel_llr(noise, sig, code.q).reshape(S * B, code.n, code.q)
    del noise
    outs = [decoder.decode(llr[i:i + block]) for i in range(0, S * B, block)]
    hard, done, iters = (torch.cat(x) for x in zip(*outs))
    return counters(hard, done, iters, S, code.p)
