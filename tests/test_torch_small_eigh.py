"""`small_eigh`'s two parallel-order Jacobi kernels, emulated in float64
numpy on the CPU.

`cora_tpu_torch/ops/csrc/small_eigh.cu` holds two kernels that must give
the same bits: the one-CTA kernel (`small_eigh_cta`: a thread per 2 × 2
block (i ≤ j) of a round, the mirrored block written by the same thread)
and the one-warp kernel the wrapper routes n ≤ 32 to (a lane per row of
A, each lane computing the entries of its own row). The emulations below
follow each kernel's order of operations: (a) block by block, (b) row by
row, where a row's entry in a block (j, i) with slot j < i is computed as
the one-CTA kernel's thread for (j, i) computes it (rows with Jⱼ first,
then columns with Jᵢ) and transposed. Both take the stop test's sums in
the one-CTA kernel's order for its thread count (a strided sum per
thread, a `__shfl_down` tree per warp, a tree over the warps), (b) by
replaying it virtual warp by virtual warp, as the one-warp kernel does.
They must agree bit for bit on A, V and the sweeps, and with
`numpy.linalg.eigh` to the tolerances of `test_torch_cert_loop.py`. The
wrapper's routing and `pair_of`'s round-robin schedule are checked too.
Everything here runs on the CPU and checks the emulations and the
wrapper's routing, not the CUDA source: the kernels themselves are held
to each other, bit for bit, only on the card, by
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
        assert se.route(n, dt) == ("warp" if n <= se.WARP_MAX_N else "cta")


@pytest.mark.parametrize("n", [0, 97, 128])
def test_route_refuses_sizes(n):
    """No kernel takes n = 0; past MAX_N the one-CTA kernel refuses (its A
    and V would overflow its shared memory) and the route is the global
    kernel's."""
    with pytest.raises(ValueError):
        se.route(n, torch.float32, kernel="cta")
    if n == 0:
        with pytest.raises(ValueError):
            se.route(n, torch.float32)
    else:
        assert se.route(n, torch.float32) == "global"


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
