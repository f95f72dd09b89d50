"""`small_eigh`'s parallel-order Jacobi kernels, emulated in float64 numpy
on the CPU.

`cora_tpu_torch/ops/csrc/small_eigh.cu` holds kernels that must give the
same bits: the one-CTA kernel (`small_eigh_cta`: a thread per 2 × 2 block
(i ≤ j) of a round, the mirrored block written by the same thread), the
one-warp kernel the wrapper routes n ≤ 32 to (a lane per row of A, each
lane computing the entries of its own row), and the cluster family the
wrapper routes 32 < n ≤ 448 to (A's rows by circle-method position over C
CTAs, each round's next pairs computed a round ahead from this round's
rows and table, the rows written straight into their next positions,
across a CTA boundary where the shift takes them there; V afterwards from
the log of rotations, by slot), and on to 1056 the same rounds on a grid
of co-resident CTAs (the crossing rows through a mailbox, each CTA's copy
of the table imported after the barrier). The emulations below follow
each kernel's order of operations: (a) block by block, (b) row by row,
where a row's entry in a block (j, i) with slot j < i is computed as the
one-CTA kernel's thread for (j, i) computes it (rows with Jⱼ first, then
columns with Jᵢ) and transposed, (c) the cluster family's positions,
tables and shift (`Cluster`), (d) with `grid`, the grid's, (e) the stream
route past 1056 (`Stream`: A by index, each CTA rewriting its pairs' rows
in place from its own rows and its copy of the table, the look-ahead lane
updating the block it reads, V by index from the log, staged in chunks
that may split a round). The stop test's sums are taken in the one-CTA kernel's
order for its thread count (a strided sum per thread, a `__shfl_down` tree
per warp, a tree over the warps), (b) replaying it virtual warp by
virtual warp, as the one-warp kernel does, (c) with the terms read from
the rows by position, up to ~60 a thread past n = 45, as the cluster
family's CTA 0 does, (d) spread over the stream route's CTAs by virtual
warp. They must agree bit for bit on A, V and the sweeps,
and with `numpy.linalg.eigh` to the tolerances of `test_torch_cert_loop.py`.
The wrapper's routing, cluster and grid sizes and workspace formulas and
`pair_of`'s round-robin schedule are checked too. Everything here runs on the CPU and checks the
emulations and the wrapper's routing, not the CUDA source: the kernels
themselves are held to each other, bit for bit, only on the card, by
`scripts/probe_small_eigh.py` and `chip_smoke.py` phase 2.
"""

import os
import sys

import numpy as np
import pytest
import torch

from cora_tpu_torch.ops import small_eigh as se

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from small_eigh_cases import corpus  # noqa: E402

EPS = np.finfo(np.float64).eps
# test_torch_cert_loop.py's tolerances for float64 eigenpairs
EIG_TOL = 1e-12
# the Rayleigh–Ritz sizes k = 10 and 3k = 30, and an odd n (a pad index)
SIZES = (10, 30, 31)


def pair_of(rd, i, npad):
    """The kernels' `pair_of`: slot i of round rd (circle method over npad
    players, npad − 1 fixed), as p < q."""
    m = npad - 1
    a, b = (rd, m) if i == 0 else ((rd + i) % m, (rd - i + m) % m)
    return min(a, b), max(a, b)


def pairs(rd, npad):
    """Round rd's pairs as the one-warp kernel derives them: no division,
    one conditional subtraction each."""
    m, P, Q = npad - 1, [], []
    for i in range(npad // 2):
        a = rd + i if i else rd
        a = a - m if a >= m else a
        b = rd - i + m if i else m
        b = b - m if (i and b >= m) else b
        P.append(min(a, b))
        Q.append(max(a, b))
    return np.array(P), np.array(Q)


def slot_of(rd, u, npad):
    """The one-warp kernel's slot of index u in round rd (the inverse of
    `pairs`), without a division."""
    m = npad - 1
    if u in (m, rd):
        return 0
    i = u - rd if u >= rd else u - rd + m
    return i if i < npad // 2 else m - i


def cta_threads(n):
    """The one-CTA kernel's launch width for n."""
    h = (n + n % 2) // 2
    t = -(-(h * h + n * h) // 32) * 32
    return min(max(t, 64), 1024)


def warp_tree(v):
    """`v += __shfl_down_sync(v, o)` for o = 16 … 1 over the last axis (a
    lane past the end reads its own value); lane 0's value."""
    for o in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[..., o:], v[..., 32 - o:]], axis=-1)
    return v[..., 0]


def thread_parts(terms, nt):
    """Each of nt threads' strided sum `part += term` over e = t, t + nt, …"""
    parts = np.zeros(nt)
    for e0 in range(0, len(terms), nt):
        chunk = terms[e0:e0 + nt]
        parts[:len(chunk)] = parts[:len(chunk)] + chunk
    return parts


def cta_sum(terms, nt):
    """The one-CTA kernel's `block_sum` of the threads' strided sums."""
    red = np.zeros(32)
    red[:nt // 32] = warp_tree(thread_parts(terms, nt).reshape(-1, 32))
    return warp_tree(red)


def replay_sum(terms, nt):
    """The same sum as the one-warp kernel takes it: virtual warp w's 32
    threads played by the 32 lanes, its tree, lane w keeping the result;
    then the tree over the lanes."""
    red = np.zeros(32)
    for w in range(nt // 32):
        parts = np.zeros(32)
        for e0 in range(w * 32, len(terms), nt):
            chunk = terms[e0:e0 + 32]
            parts[:len(chunk)] = parts[:len(chunk)] + chunk
        red[w] = warp_tree(parts)
    return warp_tree(red)


def rotations(app, aqq, apq):
    """(c, s, t) of each pair, as the kernels compute them (GVL sym.schur2)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        tau = (aqq - app) / (2.0 * apq)
        t = np.where(tau >= 0, 1.0, -1.0) / (np.abs(tau) + np.hypot(1.0, tau))
        c = 1.0 / np.sqrt(1.0 + t * t)
        s = t * c
    rot = apq != 0
    return (np.where(rot, c, 1.0), np.where(rot, s, 0.0),
            np.where(rot, t, 0.0))


def block(cr, sr, cc, sc, x00, x01, x10, x11):
    """A 2 × 2 block's update: rows with (cr, sr) first, then columns with
    (cc, sc), as the kernels' `rotate_block`."""
    y00, y01 = cr * x00 - sr * x10, cr * x01 - sr * x11
    y10, y11 = sr * x00 + cr * x10, sr * x01 + cr * x11
    return (cc * y00 - sc * y01, sc * y00 + cc * y01,
            cc * y10 - sc * y11, sc * y10 + cc * y11)


def start(M):
    """(A padded to even order from M's lower triangle, V = I, n, npad)."""
    n = M.shape[0]
    npad = n + n % 2
    A = np.zeros((npad, npad))
    A[:n, :n] = np.tril(M) + np.tril(M, -1).T
    return A, np.eye(npad), n, npad


def round_blocks(A, V, n, rd):
    """(a) One round, a thread per block (i ≤ j) of the one-CTA kernel."""
    npad, h = A.shape[0], A.shape[0] // 2
    P, Q = np.array([pair_of(rd, i, npad) for i in range(h)]).T
    c, s, t = rotations(A[P, P], A[Q, Q], A[P, Q])
    new = A.copy()
    apq = A[P, Q]
    new[P, P] = A[P, P] - t * apq
    new[Q, Q] = A[Q, Q] + t * apq
    new[P, Q] = new[Q, P] = 0.0
    i, j = np.triu_indices(h, 1)
    z = block(c[i], s[i], c[j], s[j], A[P[i], P[j]], A[P[i], Q[j]],
              A[Q[i], P[j]], A[Q[i], Q[j]])
    for (r, k), zz in zip(((P, P), (P, Q), (Q, P), (Q, Q)), z):
        new[r[i], k[j]] = zz
        new[k[j], r[i]] = zz
    vp, vq = V[:n, P].copy(), V[:n, Q].copy()
    V[:n, P] = c * vp - s * vq
    V[:n, Q] = s * vp + c * vq
    return new


def round_rows(A, V, n, rd):
    """(b) One round, a lane per row u: its slot i, its entries at every
    other slot j from its own and its partner's rows of the old A."""
    npad, h = A.shape[0], A.shape[0] // 2
    P, Q = pairs(rd, npad)
    slot = np.array([slot_of(rd, u, npad) for u in range(npad)])
    c, s, t = rotations(A[P, P], A[Q, Q], A[P, Q])
    u = np.arange(npad)[:, None]
    j = np.arange(h)[None, :]
    i = slot[u]
    top = P[i] == u
    x00, x01 = A[P[i], P[j]], A[P[i], Q[j]]
    x10, x11 = A[Q[i], P[j]], A[Q[i], Q[j]]
    lo = i < j
    # slot i < j: the block (i, j) as is; i > j: the block (j, i) = Xᵀ
    z00, z01, z10, z11 = block(
        np.where(lo, c[i], c[j]), np.where(lo, s[i], s[j]),
        np.where(lo, c[j], c[i]), np.where(lo, s[j], s[i]),
        x00, np.where(lo, x01, x10), np.where(lo, x10, x01), x11)
    at_p = np.where(top, z00, np.where(lo, z10, z01))
    at_q = np.where(top, np.where(lo, z01, z10), z11)
    new = np.empty_like(A)
    own = j == i
    rows = np.broadcast_to(u, own.shape)
    new[rows[~own], np.broadcast_to(P[j], own.shape)[~own]] = at_p[~own]
    new[rows[~own], np.broadcast_to(Q[j], own.shape)[~own]] = at_q[~own]
    uu = np.arange(npad)
    mi = slot[uu]
    mate = np.where(P[mi] == uu, Q[mi], P[mi])
    apq = A[P[mi], Q[mi]]
    new[uu, uu] = np.where(P[mi] == uu, A[P[mi], P[mi]] - t[mi] * apq,
                           A[Q[mi], Q[mi]] + t[mi] * apq)
    new[uu, mate] = 0.0
    vp, vq = V[:n, P].copy(), V[:n, Q].copy()
    V[:n, P] = c * vp - s * vq
    V[:n, Q] = s * vp + c * vq
    return new


def jacobi(M, rows, max_sweeps=se.MAX_SWEEPS):
    """(A, V, info) after the kernels' sweeps, by rows (b) or blocks (a):
    info the sweeps taken, −1 at the cap, None for a non-finite matrix."""
    A, V, n, npad = start(M)
    nt = cta_threads(n)
    total = replay_sum if rows else cta_sum
    norm2 = total((A * A).ravel(), nt)
    if not np.isfinite(norm2):
        return A, V, None
    off = ~np.eye(npad, dtype=bool)
    sweeps = 0
    while True:
        if total(np.where(off, A * A, 0.0).ravel(), nt) <= EPS * EPS * norm2:
            return A, V, sweeps
        if sweeps == max_sweeps:
            return A, V, -1
        for rd in range(npad - 1):
            A = (round_rows if rows else round_blocks)(A, V, n, rd)
        sweeps += 1


def finish(A, V, n):
    """Ascending eigenvalues (ties by index), each eigenvector's largest
    entry (the first on ties) positive."""
    d = np.diag(A)[:n]
    perm = np.argsort(d, kind="stable")
    Vs = V[:n, perm]
    at = np.abs(Vs).argmax(axis=0)
    return d[perm], Vs * np.where(Vs[at, np.arange(n)] < 0, -1.0, 1.0)


def same_bits(a, b):
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_pair_of_covers_each_pair_once_per_sweep():
    for n in range(1, se.MAX_N + 1):
        npad = n + n % 2
        seen = []
        for rd in range(npad - 1):
            P, Q = pairs(rd, npad)
            assert [tuple(x) for x in zip(P, Q)] == [
                pair_of(rd, i, npad) for i in range(npad // 2)]
            assert sorted(np.r_[P, Q]) == list(range(npad))  # disjoint
            for i, (p, q) in enumerate(zip(P, Q)):
                assert slot_of(rd, p, npad) == slot_of(rd, q, npad) == i
            seen += list(zip(P.tolist(), Q.tolist()))
        assert sorted(seen) == [(p, q) for p in range(npad)
                                for q in range(p + 1, npad)], n


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["graded", "nonfinite"])
@pytest.mark.parametrize("n", SIZES)
def test_rows_reproduce_blocks_bit_for_bit(n, case, dtype):
    M = corpus(n)[case].astype(dtype).astype(np.float64)
    Aa, Va, ia = jacobi(M, rows=False)
    Ab, Vb, ib = jacobi(M, rows=True)
    assert ia == ib
    assert (ia is None) == (case == "nonfinite")
    assert same_bits(Aa, Ab) and same_bits(Va, Vb)
    if ia is not None:
        assert ia > 0
        wa, Wa = finish(Aa, Va, n)
        wb, Wb = finish(Ab, Vb, n)
        assert same_bits(wa, wb) and same_bits(Wa, Wb)


@pytest.mark.parametrize("case", ["random", "graded", "repeated",
                                  "zero_block"])
@pytest.mark.parametrize("n", [10, 31])
def test_emulation_matches_numpy(n, case):
    M = corpus(n)[case]
    ref_w, ref_V = np.linalg.eigh(M)
    scale = max(np.abs(ref_w).max(), 1.0)
    for rows in (False, True):
        A, V, info = jacobi(M, rows)
        assert 0 < info <= se.MAX_SWEEPS
        w, V = finish(A, V, n)
        assert np.abs(w - ref_w).max() <= EIG_TOL * scale
        assert np.abs(M @ V - V * w).max() <= 10 * EIG_TOL * scale
        assert np.abs(V.T @ V - np.eye(n)).max() <= 10 * EIG_TOL


def test_stop_sum_replay_matches_cta_order():
    rng = np.random.default_rng(3)
    for n in SIZES:
        terms = rng.standard_normal((n + n % 2) ** 2) ** 2
        nt = cta_threads(n)
        assert replay_sum(terms, nt) == cta_sum(terms, nt)


@pytest.mark.parametrize("n", [1, 2, 10, 30, 31, 32, 33, 36, 64, 95, 96])
def test_route_by_size(n):
    for dt in (torch.float32, torch.float64):
        assert se.route(n, dt) == ("warp" if n <= se.WARP_MAX_N else
                                   "cluster")


@pytest.mark.parametrize("n", [0, 97, 128])
def test_route_refuses_sizes(n):
    """No kernel takes n = 0; past MAX_N the one-CTA kernel refuses (its A
    and V would overflow its shared memory) and the route is the cluster
    family's."""
    with pytest.raises(ValueError):
        se.route(n, torch.float32, kernel="cta")
    if n == 0:
        with pytest.raises(ValueError):
            se.route(n, torch.float32)
    else:
        assert se.route(n, torch.float32) == "cluster"


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32, torch.complex64])
def test_route_refuses_dtypes(dtype):
    with pytest.raises(TypeError):
        se.route(30, dtype)


def test_forced_kernel_checks_its_size():
    with pytest.raises(ValueError):
        se.route(33, torch.float32, kernel="warp")
    assert se.route(30, torch.float32, kernel="cta") == "cta"
    with pytest.raises(ValueError):
        se.route(30, torch.float32, kernel="lapack")


# ---------------------------------------------------------------------------
# (c) the cluster family


def index_at(rd, i, side, m):
    """The index at position (slot i, side) of round rd: side 0 the circle
    method's a = rd + i, side 1 its b = rd − i (slot 0: the fixed m)."""
    i, side = np.asarray(i), np.asarray(side)
    a = (rd + i) % m
    b = np.where(i == 0, m, (rd - i) % m)
    return np.where(side == 0, a, b)


def next_pos(i, side, h):
    """Where the index at (i, side) sits next round: a down a slot (slot
    0's a to slot 1's b), b up a slot (the last slot's b to its a)."""
    i, side = np.asarray(i), np.asarray(side)
    ni = np.where(side == 0, np.where(i > 0, i - 1, 1),
                  np.where(i == 0, 0, np.where(i < h - 1, i + 1, h - 1)))
    ns = np.where(side == 0, np.where(i > 0, 0, 1),
                  np.where((i > 0) & (i == h - 1), 0, 1))
    return ni, ns


def prev_pos(k, side, h):
    """Where the index at (k, side) of the next round sits in this one."""
    k = np.asarray(k)
    if side == 0:
        return np.where(k < h - 1, k + 1, h - 1), np.where(k < h - 1, 0, 1)
    return (np.where(k >= 2, k - 1, 0),
            np.where(k >= 2, 1, np.where(k == 1, 0, 1)))


def rotate_diag(app, aqq, apq, t):
    return app - t * apq, aqq + t * apq


def row_entries(top, lo, ci, si, cj, sj, x00, x01, x10, x11):
    """The one-warp kernel's `row_entries`: row u's entries (at p_j, at
    q_j) of the block of its slot i and slot j."""
    z00, z01, z10, z11 = block(np.where(lo, ci, cj), np.where(lo, si, sj),
                               np.where(lo, cj, ci), np.where(lo, sj, si),
                               x00, np.where(lo, x01, x10),
                               np.where(lo, x10, x01), x11)
    return (np.where(top, z00, np.where(lo, z10, z01)),
            np.where(top, np.where(lo, z01, z10), z11))


class Cluster:
    """The cluster kernel's rounds on A over C CTAs: rows[cta][buf][side]
    [slot − cta·S] by circle-method position, the round's table per slot
    (c, s, t, the diagonal at p and q, the pair's entry, p, q), the log of
    (c, s) per round. A row's diagonal entry is never written after the
    load (NaN here: a read of it would show), its table entry carries it.

    With `grid`, the grid route's layout on C co-resident CTAs: the
    look-ahead writes a global table; the rows that cross a CTA boundary go
    to a mailbox; at the barrier each CTA copies its incoming rows and, into
    a table of its own, every slot's (c, s, p, q) and its own and its
    neighbours' slots' t and entries, and the round reads only that table
    (the entries it does not copy are NaN, so a read of them would show, as
    would a row the mailbox did not bring: a buffer is NaN before the
    round writes it)."""

    def __init__(self, M, C, grid=False):
        A, _, self.n, self.npad = start(M)
        self.m, self.h = self.npad - 1, self.npad // 2
        self.C, self.S, self.grid = C, -(-self.h // C), grid
        self.used = -(-self.h // self.S)  # the CTAs that hold slots
        self.rows = np.zeros((C, 2, 2, self.S, self.npad))
        slots = np.arange(self.h)
        for side in (0, 1):
            u = index_at(0, slots, side, self.m)
            self.rows[slots // self.S, 0, side, slots % self.S] = A[u]
        P, Q = pairs(0, self.npad)
        c, s, t = rotations(A[P, P], A[Q, Q], A[P, Q])
        self.tab = dict(c=c, s=s, t=t, dp=A[P, P], dq=A[Q, Q], apq=A[P, Q],
                        p=P, q=Q)
        self.tabs = [self.imported(c) for c in range(C)]
        self.log = [(c, s)]
        self.cur = 0

    def slots(self, c):
        """CTA c's slots (none past the last that holds any)."""
        return np.arange(min(c * self.S, self.h), min((c + 1) * self.S, self.h))

    def imported(self, c):
        """CTA c's copy of the table: (c, s, p, q) of every slot; t and the
        three entries of its slots and their neighbours', NaN elsewhere."""
        k = self.slots(c)
        out = {key: v.copy() for key, v in self.tab.items()}
        if self.grid:
            lo = max(k[0] - 1, 0) if len(k) else 0
            hi = min(k[-1] + 2, self.h) if len(k) else 0
            for key in ("t", "dp", "dq", "apq"):
                out[key][:lo] = np.nan
                out[key][hi:] = np.nan
        return out

    def cta(self, slot):
        return np.asarray(slot) // self.S

    def row(self, buf, slot, side):
        slot = np.asarray(slot)
        return self.rows[slot // self.S, buf, side, slot % self.S]

    def p_side(self, rd, slot, tb):
        """The side of each slot's p in round rd."""
        return np.where(index_at(rd, slot, 0, self.m) == tb["p"][slot], 0, 1)

    def lookahead(self, rd, tb, k):
        """Next round's table entries at the slots k (one CTA's, or all in
        the cluster, whose CTAs share the table) from the table tb and the
        rows of each next pair's source slot on k's CTA."""
        h, m = self.h, self.m
        ia, sa = prev_pos(k, 0, h)
        ib, sb = prev_pos(k, 1, h)
        ua, ub = index_at(rd, ia, sa, m), index_at(rd, ib, sb, m)
        pp, qq = rotate_diag(tb["dp"][ia], tb["dq"][ia], tb["apq"][ia],
                             tb["t"][ia])
        da = np.where(ua == tb["p"][ia], pp, qq)
        pp, qq = rotate_diag(tb["dp"][ib], tb["dq"][ib], tb["apq"][ib],
                             tb["t"][ib])
        db = np.where(ub == tb["p"][ib], pp, qq)
        own_a = self.cta(ia) == self.cta(k)
        L, O = np.where(own_a, ia, ib), np.where(own_a, ib, ia)
        uL, uO = np.where(own_a, ua, ub), np.where(own_a, ub, ua)
        assert (self.cta(L) == self.cta(k)).all()  # rows on k's own CTA
        pL, pO, qO = tb["p"][L], tb["p"][O], tb["q"][O]
        ps = self.p_side(rd, L, tb)
        rp, rq = self.row(self.cur, L, ps), self.row(self.cur, L, 1 - ps)
        r = np.arange(len(k))
        at_p, at_q = row_entries(
            uL == pL, L < O, tb["c"][L], tb["s"][L], tb["c"][O], tb["s"][O],
            rp[r, pO], rp[r, qO], rq[r, pO], rq[r, qO])
        apq = np.where(uO == pO, at_p, at_q)
        app, aqq = np.where(ua < ub, da, db), np.where(ua < ub, db, da)
        c, s, t = rotations(app, aqq, apq)
        return dict(c=c, s=s, t=t, dp=app, dq=aqq, apq=apq,
                    p=np.minimum(ua, ub), q=np.maximum(ua, ub))

    def update(self, rd, tb, slots):
        """The rows of `slots` after the round at every column slot: (side
        of p, the p rows, the q rows), NaN where the round writes nothing."""
        h = self.h
        i = slots[:, None]
        j = np.arange(h)[None, :]
        ps = self.p_side(rd, slots, tb)
        rp = self.row(self.cur, slots, ps)
        rq = self.row(self.cur, slots, 1 - ps)
        r = np.arange(len(slots))[:, None]
        P, Q = tb["p"], tb["q"]
        x00, x01 = rp[r, P[j]], rp[r, Q[j]]
        x10, x11 = rq[r, P[j]], rq[r, Q[j]]
        lo = i < j
        z00, z01, z10, z11 = block(
            np.where(lo, tb["c"][i], tb["c"][j]),
            np.where(lo, tb["s"][i], tb["s"][j]),
            np.where(lo, tb["c"][j], tb["c"][i]),
            np.where(lo, tb["s"][j], tb["s"][i]),
            x00, np.where(lo, x01, x10), np.where(lo, x10, x01), x11)
        op = np.full((len(slots), self.npad), np.nan)
        oq = np.full((len(slots), self.npad), np.nan)
        off = i != j
        rr = np.broadcast_to(r, off.shape)
        Pj, Qj = np.broadcast_to(P[j], off.shape), np.broadcast_to(Q[j],
                                                                  off.shape)
        op[rr[off], Pj[off]] = z00[off]
        op[rr[off], Qj[off]] = np.where(lo, z01, z10)[off]
        oq[rr[off], Pj[off]] = np.where(lo, z10, z01)[off]
        oq[rr[off], Qj[off]] = z11[off]
        op[r[:, 0], Q[slots]] = 0.0
        oq[r[:, 0], P[slots]] = 0.0
        return ps, op, oq

    def round(self, rd):
        h, S, nbuf = self.h, self.S, self.cur ^ 1
        self.rows[:, nbuf] = np.nan
        nxt = {key: np.zeros(h, dtype=v.dtype) for key, v in self.tab.items()}
        mail, self.crossed = {}, 0
        for c in range(self.C if self.grid else 1):
            k = self.slots(c) if self.grid else np.arange(h)
            if not len(k):
                continue
            tb = self.tabs[c] if self.grid else self.tab
            for key, v in self.lookahead(rd, tb, k).items():
                nxt[key][k] = v
            ps, op, oq = self.update(rd, tb, k)
            for side, out in ((ps, op), (1 - ps, oq)):
                ni, ns = next_pos(k, side, h)
                for x in range(len(k)):
                    to = ni[x] // S
                    if to != k[x] // S:
                        self.crossed += 1
                        if self.grid:  # into the neighbour's mailbox
                            assert (to, ns[x]) not in mail
                            mail[to, ns[x]] = out[x]
                            continue
                    self.rows[to, nbuf, ns[x], ni[x] % S] = out[x]
        if self.grid:
            # the barrier: each CTA's incoming rows (the a-row at its last
            # slot from the next CTA, the b-row at its first from the
            # previous), then its copy of the table
            for c in range(self.C):
                k = self.slots(c)
                if len(k) and k[-1] < h - 1:
                    self.rows[c, nbuf, 0, len(k) - 1] = mail.pop((c, 0))
                if len(k) and k[0] > 0:
                    self.rows[c, nbuf, 1, 0] = mail.pop((c, 1))
            assert not mail
        self.cur, self.tab = nbuf, nxt
        self.tabs = [self.imported(c) for c in range(self.C)]
        self.log.append((nxt["c"], nxt["s"]))

    def natural(self, rd):
        """A in index order at the start of round rd (its table's)."""
        A = np.empty((self.npad, self.npad))
        slots = np.arange(self.h)
        for side in (0, 1):
            A[index_at(rd, slots, side, self.m)] = self.row(self.cur, slots,
                                                             side)
        A[self.tab["p"], self.tab["p"]] = self.tab["dp"]
        A[self.tab["q"], self.tab["q"]] = self.tab["dq"]
        return A

    def stop_sum(self, nt, off=True):
        """CTA 0's replay of the one-CTA kernel's sum for nt threads: thread
        t's terms e = t, t + nt, … in order, each read from its row at the
        row's round-0 position (the diagonal an exact 0: never read), then
        the warp trees and the tree over the warps."""
        npad, m, h = self.npad, self.m, self.h
        parts = np.zeros(nt)
        du, dv = divmod(nt, npad)
        for t in range(nt):
            u, v = divmod(t, npad)
            for _ in range(t, npad * npad, nt):
                slot = 0 if u == m else (u if u < h else m - u)
                side = int(u == m or u >= h)
                x = 0.0 if (off and u == v) else self.row(self.cur, slot,
                                                           side)[v]
                parts[t] = parts[t] + x * x
                u, v = u + du, v + dv
                if v >= npad:
                    u, v = u + 1, v - npad
        red = np.zeros(32)
        red[:nt // 32] = warp_tree(parts.reshape(-1, 32))
        return warp_tree(red)


def vectors_from_log(log, n, npad, rounds):
    """The vectors kernel: V's rows by slot, va (the index a_j) and vb
    (b_j), from V = I; a round's `rotate_v` on (V[k][p], V[k][q]) of each
    slot (a is q exactly when 1 ≤ j ≤ min(rd, m − 1 − rd)), then every
    entry moved with its index. V in index order after `rounds` rounds."""
    m, h = npad - 1, npad // 2
    j = np.arange(h)
    k = np.arange(n)[:, None]
    va = (k == j[None, :]).astype(float)
    vb = (k == np.where(j == 0, m, m - j)[None, :]).astype(float)
    for g in range(rounds):
        rd = g % m
        c, s = log[g]
        aq = (j >= 1) & (j <= min(rd, m - 1 - rd))
        vp, vq = np.where(aq, vb, va), np.where(aq, va, vb)
        np_, nq_ = c * vp - s * vq, s * vp + c * vq
        va, vb = np.where(aq, nq_, np_), np.where(aq, np_, nq_)
        na = np.concatenate([va[:, 1:], vb[:, h - 1:]], axis=1)
        nb = np.concatenate([vb[:, :1], va[:, :1], vb[:, 1:h - 1]], axis=1)
        va, vb = na, nb
    rd = rounds % m
    V = np.zeros((npad, npad))
    V[:n, index_at(rd, j, 0, m)] = va
    V[:n, index_at(rd, j, 1, m)] = vb
    return V


# around the one-CTA kernel's 96, a certificate at rank 31 (99), 48, 64
# and 80 (150, 198, 246: routed to 2, 4 and 8 CTAs), and the odd 35 (a pad
# index)
CLUSTER_SIZES = (33, 35, 36, 96, 97, 99, 150, 198, 246)


def cluster_sizes(n):
    """The kernel's cluster size at n and every other that holds it."""
    return [c for c in (1, 2, 4, 8) if se.cluster_fits(n, c)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", CLUSTER_SIZES)
def test_cluster_rounds_reproduce_blocks_bit_for_bit(n, dtype):
    """A sweep and a round of the cluster family, at the kernel's cluster
    size and the largest that holds n, against the one-CTA kernel's
    blocks, round by round: A (the rows by position, the diagonal from the
    table) and, from the log, V."""
    M = corpus(n)["random"].astype(dtype).astype(np.float64)
    A0, V0, _, npad = start(M)
    rounds = npad  # a whole sweep and one round of the next
    for C in sorted({se.cluster_size(n), cluster_sizes(n)[-1]}):
        emu = Cluster(M, C)
        A, V = A0.copy(), V0.copy()
        crossed = 0
        for g in range(rounds):
            rd = g % (npad - 1)
            A = round_blocks(A, V, n, rd)
            emu.round(rd)
            crossed += emu.crossed
            assert same_bits(emu.natural((rd + 1) % (npad - 1)), A), (C, g)
        # two rows each boundary
        assert crossed == 2 * (emu.used - 1) * rounds
        Vc = vectors_from_log(emu.log, n, npad, rounds)
        assert same_bits(Vc[:n], V[:n]), C


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [33, 99])
def test_cluster_runs_to_the_blocks_result(n, dtype):
    """The cluster family to convergence (stop tests by its replay) against
    `jacobi` by blocks: the same sweeps, A and V bit for bit."""
    M = corpus(n)["graded"].astype(dtype).astype(np.float64)
    A, V, info = jacobi(M, rows=False)
    emu = Cluster(M, se.cluster_size(n))
    npad = emu.npad
    nt = cta_threads(n)
    norm2 = cta_sum((start(M)[0] ** 2).ravel(), nt)
    sweeps = 0
    while emu.stop_sum(nt) > EPS * EPS * norm2:
        for rd in range(npad - 1):
            emu.round(rd)
        sweeps += 1
    assert sweeps == info
    assert same_bits(emu.natural(0), A)
    Vc = vectors_from_log(emu.log, n, npad, sweeps * (npad - 1))
    assert same_bits(Vc[:n], V[:n])


@pytest.mark.parametrize("n", [33, 36, 97, 99, 150, 198, 246])
def test_cluster_stop_sum_replays_cta_order(n):
    """The stop test as the cluster family's CTA 0 takes it, over 1024
    threads with many terms each past n = 45, reading rows by position:
    the one-CTA kernel's sum of the same entries, bit for bit."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    emu = Cluster(M + M.T, cluster_sizes(n)[-1])
    nt = cta_threads(n)
    npad = emu.npad
    A = emu.natural(0)
    off = ~np.eye(npad, dtype=bool)
    assert emu.stop_sum(nt) == cta_sum(np.where(off, A * A, 0.0).ravel(), nt)
    assert emu.stop_sum(nt, off=False) == cta_sum((A * A).ravel(), nt)
    if n > 45:
        assert nt == 1024 and npad * npad > 2 * nt


@pytest.mark.parametrize("n", [32, 33, 116, 117, 164, 165, 232, 233, 246,
                               320, 321, 448, 449, 456, 1056, 1057])
def test_route_cluster_and_global_by_size(n):
    """32 < n ≤ CLUSTER_MAX_N to the cluster family, to GRID_MAX_N the
    grid, past it the stream route (the global kernel only where forced);
    the cluster size is the smallest power of two whose shared memory holds
    A twice (and two pairs a CTA)."""
    want = ("warp" if n <= se.WARP_MAX_N else
            "cluster" if n <= se.CLUSTER_MAX_N else
            "grid" if n <= se.GRID_MAX_N else "stream")
    for dt in (torch.float32, torch.float64):
        assert se.route(n, dt) == want
        assert se.route(n, dt, kernel="global") == "global"
    C = se.cluster_size(n)
    if n > se.CLUSTER_MAX_N:
        assert C == 0 and not any(se.cluster_fits(n, c) for c in range(1, 17))
        return
    assert C in (1, 2, 4, 8, 16)
    assert se.cluster_smem_bytes(n, C) <= se.CLUSTER_SMEM
    assert C == 1 or not se.cluster_fits(n, C // 2)


def test_cluster_sizes_at_the_boundaries():
    assert [se.cluster_size(n) for n in (33, 99, 116, 117, 150, 164, 165,
                                         232, 233, 246, 320, 321, 324, 448,
                                         449)] \
        == [1, 1, 1, 2, 2, 2, 4, 4, 8, 8, 8, 16, 16, 16, 0]
    assert se.CLUSTER_MAX_N == max(n for n in range(1, 600)
                                   if se.cluster_size(n))
    # every n of the 16-CTA range on 16 CTAs (the last few may hold one
    # pair, or none: 321-332 leave the sixteenth CTA empty)
    assert all(se.cluster_size(n) == 16 for n in range(321, 449))


@pytest.mark.parametrize("n", [2, 449, 456])
def test_forced_cluster_checks_its_size(n):
    with pytest.raises(ValueError):
        se.route(n, torch.float64, kernel="cluster")
    assert se.route(3, torch.float64, kernel="cluster") == "cluster"
    assert se.route(320, torch.float32, kernel="cluster") == "cluster"
    assert se.route(448, torch.float32, kernel="cluster") == "cluster"


# ---------------------------------------------------------------------------
# (d) the grid route


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [320, 321, 448, 449, 1056, 1057])
def test_grid_route_boundaries(n, dtype):
    """448 < n ≤ 1056 to the grid, on the most CTAs (at most the card's
    132) that hold the rows twice and the table with ≥ 2 pairs a CTA;
    past 1056 the stream route (A by index in L2, no rows in shared
    memory), which the grid refuses."""
    dt = getattr(torch, dtype)
    want = ("cluster" if n <= se.CLUSTER_MAX_N else
            "grid" if n <= se.GRID_MAX_N else "stream")
    assert se.route(n, dt) == want
    G = se.grid_size(n)
    if n > se.GRID_MAX_N:
        assert G == 0 and se.stream_size(n) == 106
        with pytest.raises(ValueError):
            se.route(n, dt, kernel="grid")
        return
    assert 2 <= G <= se.GRID_MAX_G and se.grid_fits(n, G)
    h = (n + n % 2) // 2
    S = -(-h // G)
    # two pairs a CTA, or one fewer would take more CTAs than the card has
    assert S >= 2 and (S == 2 or -(-h // (S - 1)) > se.GRID_MAX_G)
    assert se.cluster_smem_bytes(n, G) <= se.CLUSTER_SMEM
    assert se.route(n, dt, kernel="grid") == "grid"


def test_grid_sizes():
    """The CTA counts at the certificates' n = 3(r + 2): rank 150 (456),
    170 (516), 331 (1000) and 350 (1056); and 449, whose last CTA holds
    one pair."""
    assert [se.grid_size(n) for n in (449, 456, 516, 768, 1000, 1056)] \
        == [113, 114, 129, 128, 125, 132]
    h = 225  # n = 449
    S = -(-h // 113)
    assert h - 112 * S == 1
    assert se.GRID_MAX_N == 1056
    assert all(se.grid_size(n) for n in range(449, se.GRID_MAX_N + 1))
    assert not se.grid_size(se.GRID_MAX_N + 1)


def test_grid_workspace():
    """The workspace formulas: per matrix the cluster family's (the log,
    MAX_SWEEPS·(n_p − 1) + 1 rounds of (c, s) per pair, 16 B each; V and A;
    two ints), then the grid's table, mailbox and barrier words once."""
    for n in (324, 448, 456, 1000, 1056):
        npad = n + n % 2
        h = npad // 2
        log = 16 * (se.MAX_SWEEPS * (npad - 1) + 1) * h
        per = se.cluster_work_doubles(n, se.MAX_SWEEPS)
        assert per % 2 == 0 and 8 * per >= log + 2 * 8 * npad * npad + 8
        assert 8 * per - (log + 2 * 8 * npad * npad) <= 16
        G = se.grid_size(n)
        for batch in (1, 3):
            total = se.grid_work_doubles(n, se.MAX_SWEEPS, batch)
            extra = total - batch * per
            if G:
                assert extra >= 2 * (7 * h) + 4 * G * npad + 1
                assert extra % 2 == 0 and extra - (2 * (7 * h + h % 2)
                                                   + 4 * G * npad + 1) <= 1
    # the log's size, as the route's docstring gives it
    mb = {n: 16 * (se.MAX_SWEEPS * (n - 1) + 1) * (n // 2) / 1e6
          for n in (324, 448, 456, 1000, 1056)}
    assert [round(mb[n]) for n in (324, 448, 456, 1000, 1056)] \
        == [25, 48, 50, 240, 267]


# the grid emulated against the one-CTA kernel's blocks: uneven last CTAs
# (99 on 3: 17, 17, 16 pairs; 64 on 7: five of 5, 2), one pair on the last
# (33 on 16: 9 CTAs of 2, then 1, then empty ones), and the grid's smallest
GRID_CASES = ((33, 3), (33, 16), (35, 5), (64, 7), (99, 3), (99, 16),
              (36, 2))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n, G", GRID_CASES)
def test_grid_rounds_reproduce_blocks_bit_for_bit(n, G, dtype):
    """A sweep and a round of the grid layout, rows across CTA boundaries
    through the mailbox and each CTA reading only its imported table,
    against the one-CTA kernel's blocks, round by round: A (the rows by
    position, the diagonal from the table) and, from the log, V."""
    M = corpus(n)["random"].astype(dtype).astype(np.float64)
    A, V, _, npad = start(M)
    emu = Cluster(M, G, grid=True)
    rounds = npad  # a whole sweep and one round of the next
    crossed = 0
    for g in range(rounds):
        rd = g % (npad - 1)
        A = round_blocks(A, V, n, rd)
        emu.round(rd)
        crossed += emu.crossed
        assert same_bits(emu.natural((rd + 1) % (npad - 1)), A), (G, g)
    assert crossed == 2 * (emu.used - 1) * rounds  # two rows each boundary
    Vc = vectors_from_log(emu.log, n, npad, rounds)
    assert same_bits(Vc[:n], V[:n])


@pytest.mark.parametrize("n, G", [(33, 16), (99, 3)])
def test_grid_runs_to_the_blocks_result(n, G):
    """The grid layout to convergence (stop tests on the workspace copy of
    the rows) against `jacobi` by blocks: the same sweeps, A and V bit for
    bit."""
    M = corpus(n)["graded"]
    A, V, info = jacobi(M, rows=False)
    emu = Cluster(M, G, grid=True)
    nt = cta_threads(n)
    norm2 = cta_sum((start(M)[0] ** 2).ravel(), nt)
    sweeps = 0
    while grid_stop_sum(emu, nt) > EPS * EPS * norm2:
        for rd in range(emu.npad - 1):
            emu.round(rd)
        sweeps += 1
    assert sweeps == info
    assert same_bits(emu.natural(0), A)
    Vc = vectors_from_log(emu.log, n, emu.npad, sweeps * (emu.npad - 1))
    assert same_bits(Vc[:n], V[:n])


def grid_stop_sum(emu, nt, off=True):
    """The grid's stop test: each CTA writes its rows at their round-0
    positions into the workspace A by index (its diagonal never written:
    NaN), CTA 0 sums it in the one-CTA kernel's order for nt threads
    (thread t's terms e = t, t + nt, …, its (u, v) stepped as the kernel
    steps them, the diagonal an exact 0), the warp trees, the tree over the
    warps."""
    npad, m = emu.npad, emu.m
    Ad = np.full((npad, npad), np.nan)
    for c in range(emu.C):
        k = emu.slots(c)
        for side in (0, 1):
            Ad[index_at(0, k, side, m)] = emu.rows[c, emu.cur, side,
                                                   :len(k)]
    du, dv = divmod(nt, npad)
    t = np.arange(nt)
    u, v = np.divmod(t, npad)
    parts = np.zeros(nt)
    for e0 in range(0, npad * npad, nt):
        live = t + e0 < npad * npad
        assert (u * npad + v == t + e0)[live].all()  # the kernel's stepping
        uu, vv = np.where(live, u, 0), np.where(live, v, 0)
        x = np.where(live & ~(off & (uu == vv)), Ad[uu, vv], 0.0)
        parts = parts + x * x
        u, v = u + du, v + dv
        wrap = v >= npad
        u, v = np.where(wrap, u + 1, u), np.where(wrap, v - npad, v)
    red = np.zeros(32)
    red[:nt // 32] = warp_tree(parts.reshape(-1, 32))
    return warp_tree(red)


@pytest.mark.parametrize("n", [449, 516, 1056])
def test_grid_stop_sum_replays_cta_order(n):
    """The grid's stop test at its own sizes (G = 113, 129 and 132 CTAs, the
    last of 449's holding one pair), over 1024 threads with up to ~1090
    terms each: the one-CTA kernel's sum of the same entries, bit for
    bit."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    emu = Cluster(M + M.T, se.grid_size(n), grid=True)
    nt = cta_threads(n)
    assert nt == 1024
    A = emu.natural(0)
    offd = ~np.eye(emu.npad, dtype=bool)
    assert grid_stop_sum(emu, nt) == cta_sum(np.where(offd, A * A,
                                                      0.0).ravel(), nt)
    # the first test sums the rows as loaded (the diagonal from the input)
    B = start(M + M.T)[0]
    assert cta_sum((B * B).ravel(), nt) == cta_sum((A * A).ravel(), nt)


# ---------------------------------------------------------------------------
# (e) the stream route


def block_rows(lo, ci, si, cj, sj, x00, x01, x10, x11):
    """The kernels' `block_rows_rn`: rows p_i and q_i's entries at columns
    (p_j, q_j) of the block of slots i and j, the block (min, max) as the
    one-CTA kernel's thread computes it (transposed where i > j)."""
    z00, z01, z10, z11 = block(np.where(lo, ci, cj), np.where(lo, si, sj),
                               np.where(lo, cj, ci), np.where(lo, sj, si),
                               x00, np.where(lo, x01, x10),
                               np.where(lo, x10, x01), x11)
    return z00, np.where(lo, z01, z10), np.where(lo, z10, z01), z11


def ahead_src(k, h, m, rd, s0, s1):
    """Next round's slots k: their indices' positions this round, the
    indices there, and of the two source slots the one on k's CTA (L, its
    index uL) and the other (O, uO)."""
    ia, sa = prev_pos(k, 0, h)
    ib, sb = prev_pos(k, 1, h)
    ua, ub = index_at(rd, ia, sa, m), index_at(rd, ib, sb, m)
    own_a = (ia >= s0) & (ia < s1)
    return dict(ia=ia, ib=ib, ua=ua, ub=ub, L=np.where(own_a, ia, ib),
                O=np.where(own_a, ib, ia), uL=np.where(own_a, ua, ub),
                uO=np.where(own_a, ub, ua))


class Stream:
    """The stream route's rounds on G co-resident CTAs: A by index in one
    global array (the kernel's L2 workspace), CTA c owning the rows of its
    slots [c·S, c·S + S) in every round and rewriting them in place, each
    from what it may read: its own rows (every other row NaN in its view)
    and its imported copy of the round's table ((c, s, p, q) of every slot,
    t and the entries of its own and its neighbours' slots, NaN elsewhere).
    Warp 0's look-ahead lane for next slot k updates the block of k's two
    source slots on the rows of the one on k's CTA itself and takes the
    entry between k's indices from it; the update warps skip those blocks.
    Every off-diagonal entry of A is written once a round; the diagonal is
    never written after the load nor read (NaN here: a read would show),
    the table carries it."""

    def __init__(self, M, G):
        A, _, self.n, self.npad = start(M)
        self.m, self.h = self.npad - 1, self.npad // 2
        self.G, self.S = G, -(-self.h // G)
        assert -(-self.h // self.S) == G  # every CTA holds a slot
        P, Q = pairs(0, self.npad)
        c, s, t = rotations(A[P, P], A[Q, Q], A[P, Q])
        self.tab = dict(c=c, s=s, t=t, dp=A[P, P], dq=A[Q, Q], apq=A[P, Q],
                        p=P, q=Q)
        self.loaded = A.copy()
        self.A = A
        np.fill_diagonal(self.A, np.nan)
        self.log = [(c, s)]
        self.skips = [self.skip(c) for c in range(G)]

    def slots(self, c):
        return np.arange(c * self.S, min((c + 1) * self.S, self.h))

    def skip(self, c):
        """Per own slot, the column slots whose block the look-ahead lanes
        update (on the slot's rows), at most two; −1: none."""
        k = self.slots(c)
        src = ahead_src(k, self.h, self.m, 0, k[0], k[-1] + 1)
        out = np.full((len(k), 2), -1)
        for L, O in zip(src["L"], src["O"]):
            x = L - k[0]
            out[x, int(out[x, 0] >= 0)] = O
        return out

    def imported(self, c):
        k = self.slots(c)
        lo, hi = max(k[0] - 1, 0), min(k[-1] + 2, self.h)
        out = {key: v.copy() for key, v in self.tab.items()}
        for key in ("t", "dp", "dq", "apq"):
            out[key][:lo] = np.nan
            out[key][hi:] = np.nan
        return out

    def round(self, rd):
        h, m, npad = self.h, self.m, self.npad
        new = self.A.copy()
        written = np.zeros((npad, npad), dtype=int)
        nxt = {key: np.zeros(h, dtype=v.dtype) for key, v in self.tab.items()}
        for c in range(self.G):
            k = self.slots(c)
            tb = self.imported(c)
            P, Q = tb["p"], tb["q"]
            view = np.full((npad, npad), np.nan)  # what CTA c may read
            own = np.r_[P[k], Q[k]]
            view[own] = self.A[own]
            # warp 0: next round's table of slots k, each lane updating the
            # block it reads
            src = ahead_src(k, h, m, rd, k[0], k[-1] + 1)
            L, O = src["L"], src["O"]
            assert np.isin(L, k).all()
            pL, qL, pO, qO = P[L], Q[L], P[O], Q[O]
            z = block_rows(L < O, tb["c"][L], tb["s"][L], tb["c"][O],
                           tb["s"][O], view[pL, pO], view[pL, qO],
                           view[qL, pO], view[qL, qO])
            for (r, col), zz in zip(((pL, pO), (pL, qO), (qL, pO), (qL, qO)),
                                    z):
                new[r, col] = zz
                written[r, col] += 1
            top = src["uL"] == pL
            at_p, at_q = np.where(top, z[0], z[2]), np.where(top, z[1], z[3])
            ua, ub = src["ua"], src["ub"]
            d = []
            for slot, u in ((src["ia"], ua), (src["ib"], ub)):
                pp, qq = rotate_diag(tb["dp"][slot], tb["dq"][slot],
                                     tb["apq"][slot], tb["t"][slot])
                d.append(np.where(u == P[slot], pp, qq))
            apq = np.where(src["uO"] == pO, at_p, at_q)
            app = np.where(ua < ub, d[0], d[1])
            aqq = np.where(ua < ub, d[1], d[0])
            cc, ss, tt = rotations(app, aqq, apq)
            for key, v in dict(c=cc, s=ss, t=tt, dp=app, dq=aqq, apq=apq,
                               p=np.minimum(ua, ub),
                               q=np.maximum(ua, ub)).items():
                assert np.isfinite(v).all() or key == "apq"
                nxt[key][k] = v
            # the update warps: every other block of the CTA's rows, in place
            i = k[:, None]
            j = np.arange(h)[None, :]
            skip = self.skips[c]
            todo = (j != i) & (j != skip[:, :1]) & (j != skip[:, 1:])
            ii, jj = np.broadcast_arrays(i, j)
            ii, jj = ii[todo], jj[todo]
            z = block_rows(ii < jj, tb["c"][ii], tb["s"][ii], tb["c"][jj],
                           tb["s"][jj], view[P[ii], P[jj]], view[P[ii], Q[jj]],
                           view[Q[ii], P[jj]], view[Q[ii], Q[jj]])
            for (r, col), zz in zip(((P[ii], P[jj]), (P[ii], Q[jj]),
                                     (Q[ii], P[jj]), (Q[ii], Q[jj])), z):
                new[r, col] = zz
                written[r, col] += 1
            new[P[k], Q[k]] = new[Q[k], P[k]] = 0.0
            written[P[k], Q[k]] += 1
            written[Q[k], P[k]] += 1
        # every off-diagonal entry once, by the CTA that owns its row
        assert (written == ~np.eye(npad, dtype=bool)).all()
        self.A, self.tab = new, nxt
        self.log.append((nxt["c"], nxt["s"]))

    def natural(self):
        A = self.A.copy()
        A[self.tab["p"], self.tab["p"]] = self.tab["dp"]
        A[self.tab["q"], self.tab["q"]] = self.tab["dq"]
        return A

    def stop_sum(self, nt, off=True):
        """The stop test spread over the CTAs: virtual warp v of the one-CTA
        kernel's nt threads on CTA v mod G, each lane's strided sum over A
        by index (e = t, t + nt, …, its (u, v) stepped as the kernel steps
        them, the diagonal an exact 0 where `off`, eight loads at a time),
        the warp's tree into its partial; then the tree over the partials,
        as every CTA takes it after the barrier. The sum with the diagonal
        (`off` False) reads A as loaded (the first test's)."""
        npad = self.npad
        A = self.A if off else self.loaded
        size, nw = npad * npad, nt // 32
        du, dv = divmod(nt, npad)
        part, done = np.zeros(32), []
        for c in range(self.G):
            for v in range(c, nw, self.G):
                t = 32 * v + np.arange(32)
                u, w = np.divmod(t, npad)
                acc = np.zeros(32)
                for e0 in range(0, size, 8 * nt):
                    for kk in range(8):
                        e = t + e0 + kk * nt
                        live = e < size
                        assert (u * npad + w == e)[live].all()
                        a = A.ravel()[np.where(live, e, 0)]
                        x = np.where(live & ~(off & (u == w)), a, 0.0)
                        acc = np.where(live, acc + x * x, acc)
                        u, w = np.where(live, u + du, u), np.where(live, w + dv, w)
                        wrap = w >= npad
                        u, w = np.where(wrap, u + 1, u), np.where(wrap, w - npad, w)
                part[v] = warp_tree(acc)
                done.append(v)
        assert sorted(done) == list(range(nw))
        return warp_tree(part)


def vectors_by_index(log, n, npad, rounds):
    """The stream route's vectors kernel: row k of V by index from V = I; a
    round applies `rotate_v` to (V[k][p], V[k][q]) of each slot's pair."""
    m = npad - 1
    V = np.zeros((npad, npad))
    V[:n, :n] = np.eye(n)
    for g in range(rounds):
        P, Q = pairs(g % m, npad)
        c, s = log[g]
        vp, vq = V[:n, P].copy(), V[:n, Q].copy()
        V[:n, P] = c * vp - s * vq
        V[:n, Q] = s * vp + c * vq
    return V


def vectors_by_chunks(log, n, npad, rounds, ce):
    """The stream route's vectors kernel past h = 544: the log flattened
    ((c, s) of slot j of round g at g·h + j) and staged `ce` entries at a
    time, a round split between two chunks applied in its two parts in
    turn (slots [ja, jb) of round g)."""
    m, h = npad - 1, npad // 2
    flat_c = np.concatenate([log[g][0] for g in range(rounds)])
    flat_s = np.concatenate([log[g][1] for g in range(rounds)])
    V = np.zeros((npad, npad))
    V[:n, :n] = np.eye(n)
    total = rounds * h
    for e0 in range(0, total, ce):
        e1 = min(e0 + ce, total)
        for g in range(e0 // h, (e1 - 1) // h + 1):
            ja, jb = max(e0, g * h) - g * h, min(e1, g * h + h) - g * h
            P, Q = pairs(g % m, npad)
            P, Q = P[ja:jb], Q[ja:jb]
            c, s = flat_c[g * h + ja:g * h + jb], flat_s[g * h + ja:g * h + jb]
            vp, vq = V[:n, P].copy(), V[:n, Q].copy()
            V[:n, P] = c * vp - s * vq
            V[:n, Q] = s * vp + c * vq
    return V


# the stream route emulated against the one-CTA kernel's blocks: two to nine
# CTAs, uneven last ones (33 on 2: 9, 8 pairs; 99 on 9: 8 of 6, 2; 120 on 7:
# 6 of 9, 6), one pair on the last (35 on 9: 8 of 2, 1; 64 on 8: 7 of 5, 1),
# and the stream's smallest (5 on 2)
STREAM_CASES = ((5, 2), (33, 2), (35, 9), (36, 6), (64, 8), (99, 9),
                (120, 7))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n, G", STREAM_CASES)
def test_stream_rounds_reproduce_blocks_bit_for_bit(n, G, dtype):
    """A sweep and a round of the stream route, each CTA reading only its
    own rows and its imported table and rewriting its rows in place,
    against the one-CTA kernel's blocks, round by round: A (by index, the
    diagonal from the table) and, from the log, V by index."""
    M = corpus(n)["random"].astype(dtype).astype(np.float64)
    A, V, _, npad = start(M)
    emu = Stream(M, G)
    rounds = npad  # a whole sweep and one round of the next
    for g in range(rounds):
        rd = g % (npad - 1)
        A = round_blocks(A, V, n, rd)
        emu.round(rd)
        assert same_bits(emu.natural(), A), (G, g)
    Vs = vectors_by_index(emu.log, n, npad, rounds)
    assert same_bits(Vs[:n], V[:n])


@pytest.mark.parametrize("n, G", [(33, 3), (64, 8), (99, 9), (120, 2)])
def test_stream_runs_to_the_blocks_result(n, G):
    """The stream route to convergence (the stop tests spread over its
    CTAs) against `jacobi` by blocks: the same sweeps, A and V bit for
    bit."""
    M = corpus(n)["graded"]
    A, V, info = jacobi(M, rows=False)
    emu = Stream(M, G)
    nt = cta_threads(n)
    norm2 = emu.stop_sum(nt, off=False)
    assert norm2 == cta_sum((start(M)[0] ** 2).ravel(), nt)
    sweeps = 0
    while emu.stop_sum(nt) > EPS * EPS * norm2:
        for rd in range(emu.npad - 1):
            emu.round(rd)
        sweeps += 1
    assert sweeps == info
    assert same_bits(emu.natural(), A)
    Vs = vectors_by_index(emu.log, n, emu.npad, sweeps * (emu.npad - 1))
    assert same_bits(Vs[:n], V[:n])


@pytest.mark.parametrize("n, G", [(36, 6), (99, 9)])
@pytest.mark.parametrize("chunk", ["min", "part", "whole", "many"])
def test_stream_vectors_in_chunks(n, G, chunk):
    """V from the log staged in chunks that split rounds (the fewest entries,
    a round less one, a round and three, several rounds and a part) has the
    bits of V from the log a round at a time, and of the blocks' V."""
    M = corpus(n)["random"]
    A, V, _, npad = start(M)
    h = npad // 2
    emu = Stream(M, G)
    rounds = 2 * (npad - 1) + 1  # two sweeps and a round
    for g in range(rounds):
        A = round_blocks(A, V, n, g % (npad - 1))
        emu.round(g % (npad - 1))
    ce = {"min": se.VS_MIN_CHUNK, "part": h - 1, "whole": h + 3,
          "many": 3 * h + 5}[chunk]
    Vc = vectors_by_chunks(emu.log, n, npad, rounds, ce)
    assert same_bits(Vc[:n], vectors_by_index(emu.log, n, npad, rounds)[:n])
    assert same_bits(Vc[:n], V[:n])


def test_stream_largest_size():
    """`STREAM_MAX_N`: the largest n whose sort ranking (12·n B) fits a
    block's shared memory, the limit that binds first (the CTAs' round
    table and the vectors kernel's row of V and two chunks of the log fit
    past it); every n from `STREAM_MIN_N` to it fits. Past it the route
    refuses, routed and forced; before it the card's memory runs out (the
    rotation log, 240·n² B at `MAX_SWEEPS` = 30, is past 80 GB)."""
    top = se.STREAM_MAX_N
    assert se.stream_fits(top) and not se.stream_fits(top + 1)
    assert 12 * top <= se.VEC_SMEM < 12 * (top + 1)
    assert se.stream_smem_bytes(top + 1, se.stream_size(top + 1)) \
        <= se.CLUSTER_SMEM
    assert 8 * (top + 2) + 2 * se.VS_MIN_CHUNK * 16 <= se.VEC_SMEM
    assert all(se.stream_fits(n) for n in range(se.STREAM_MIN_N, top + 1))
    assert not any(se.stream_fits(n) for n in range(se.STREAM_MIN_N))
    for dt in (torch.float32, torch.float64):
        assert se.route(top, dt) == "stream"
        assert se.route(top, dt, kernel="stream") == "stream"
        assert se.route(top + 1, dt, kernel="global") == "global"
        for kernel in (None, "stream"):
            with pytest.raises(ValueError, match="19370"):
                se.route(top + 1, dt, kernel=kernel)
    log = 16 * (se.MAX_SWEEPS * (top - 1) + 1) * (top // 2)
    assert log > 80e9 and top < 2 ** 15


@pytest.mark.parametrize("n, G", [(33, 2), (45, 5), (99, 9), (200, 7),
                                  (449, 113)])
def test_stream_stop_sum_replays_cta_order(n, G):
    """The stop test's partial sums spread over G CTAs by virtual warp (past
    G = 32 one virtual warp a CTA, some CTAs none), eight loads at a time,
    the tree over the partials after the barrier: the one-CTA kernel's sum
    of the same entries, bit for bit, with and without the diagonal."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    emu = Stream(M + M.T, G)
    nt = cta_threads(n)
    A = emu.natural()
    offd = ~np.eye(emu.npad, dtype=bool)
    assert emu.stop_sum(nt) == cta_sum(np.where(offd, A * A, 0.0).ravel(), nt)
    B = start(M + M.T)[0]
    assert emu.stop_sum(nt, off=False) == cta_sum((B * B).ravel(), nt)


def test_stream_lookahead_blocks():
    """The look-ahead lanes' blocks: at most two per source slot, each
    update warp skipping them, and no block taken by two next slots once
    there are three pairs (n ≥ STREAM_MIN_N); at two pairs both next slots
    would take slots 0 and 1's block, hence the route's smallest n."""
    for n in range(se.STREAM_MIN_N, 140):
        h = (n + n % 2) // 2
        G = se.stream_size(n)
        S = -(-h // G)
        blocks = []
        for c in range(G):
            k = np.arange(c * S, min((c + 1) * S, h))
            src = ahead_src(k, h, h + h - 1, 0, k[0], k[-1] + 1)
            assert np.isin(src["L"], k).all()
            blocks += [frozenset(x) for x in zip(src["L"], src["O"])]
        assert len(set(blocks)) == h, n
    src = ahead_src(np.arange(2), 2, 3, 0, 0, 2)
    assert {frozenset(x) for x in zip(src["L"], src["O"])} == {frozenset((0, 1))}


@pytest.mark.parametrize("n", [1056, 1057, 1062, 1536, 2112])
def test_stream_route_and_sizes(n):
    """Past GRID_MAX_N the stream route, on the most CTAs (at most the
    card's 132) with ≥ 2 pairs each; its shared memory (the table, not the
    rows) far below the block's; at 1056 the grid, the stream where
    forced."""
    h = (n + n % 2) // 2
    G = se.stream_size(n)
    S = -(-h // G)
    assert 2 <= G <= se.GRID_MAX_G and S >= 2 and -(-h // S) == G
    assert S == 2 or -(-h // (S - 1)) > se.GRID_MAX_G
    assert se.stream_smem_bytes(n, G) <= 25 * 1024 < se.CLUSTER_SMEM
    for dt in (torch.float32, torch.float64):
        assert se.route(n, dt) == ("grid" if n <= se.GRID_MAX_N else "stream")
        assert se.route(n, dt, kernel="stream") == "stream"
        assert se.route(n, dt, kernel="global") == "global"
    assert {1057: 106, 1062: 107, 1536: 128, 2112: 132}.get(n, G) == G


def test_stream_forced_sizes():
    """The stream route where forced, from n = STREAM_MIN_N (the bit
    comparisons with the one-CTA kernel, the grid and the global kernel);
    below it refused."""
    for n in (5, 36, 96, 99, 516, 1056):
        assert se.route(n, torch.float32, kernel="stream") == "stream"
        assert se.stream_size(n) >= 2
    for n in (1, 3, 4):
        assert se.stream_size(n) == 0
        with pytest.raises(ValueError):
            se.route(n, torch.float64, kernel="stream")
    assert [se.stream_size(n) for n in (5, 36, 99, 516)] == [2, 9, 25, 129]


def test_stream_workspace():
    """The stream route's workspace: per matrix the cluster family's (the
    log, V, A by index, two ints), then the global table (two parities of
    7h), the partial sums (2 × 64) and the count once; the log is 270 MB at
    n = 1062 and 1.07 GB at 2112, A 9 MB and 36 MB."""
    for n in (5, 99, 1057, 1062, 2112):
        npad = n + n % 2
        h = npad // 2
        per = se.cluster_work_doubles(n, se.MAX_SWEEPS)
        for batch in (1, 2, 3):
            total = se.stream_work_doubles(n, se.MAX_SWEEPS, batch)
            extra = total - batch * per
            assert total % 2 == 0
            assert 0 <= extra - (2 * (7 * h + h % 2) + 128 + 1) <= 1
    log = {n: 16 * (se.MAX_SWEEPS * (n - 1) + 1) * (n // 2)
           for n in (1062, 2112)}
    assert round(log[1062] / 1e6) == 270 and round(log[2112] / 1e9, 2) == 1.07
    assert [round(8 * n * n / 1e6) for n in (1062, 2112)] == [9, 36]
