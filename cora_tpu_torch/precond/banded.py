"""Banded block-Cholesky + Woodbury factorization of Q + λI on the host —
the counterpart of the reference's CHOLMOD `RegularizedCholesky`
(`src/CORA_problem.cpp:544-614`, `src/CORA_preconditioners.cpp`).

Key observation: under the natural odometry ordering, range-aided SLAM
graphs are *near-banded*. Permuting the state to interleave each pose's
rotation rows with its translation row —

    π = [R_0, t_0 | R_1, t_1 | … | R_{n-1}, t_{n-1} | landmarks]

— and eliminating the unit-bearing (sphere) rows first (their block of
Q is diagonal), the regularized data matrix M = Q + λI becomes

    [ B   C ]      B: block-tridiagonal with (d+1)×(d+1) blocks,
    [ Cᵀ  E ]      C: a handful of dense landmark columns,
                   E: small (l×l) landmark block,

exactly (no fill) for odometry chains. The factorization is: sphere-row
elimination → banded Cholesky of B (L_i, M_i blocks) → Woodbury for the
landmark columns (B⁻¹C and the l×l capacitance inverse).

The factorization runs on the host in numpy/scipy, under a reverse
Cuthill–McKee pose ordering that keeps multi-robot graphs banded. Two
device forms apply it: the chain plan of the kernels
(`cora_tpu_torch.ops.chain`, identity ordering, pose-pair blocks) and,
for any graph, `device_factor` + `banded_apply` below, whose triangular
solves are log-depth doubling scans with precomputed propagators.
Certification uses `factor_banded(..., require_exact=True)` as its exact
PSD decision.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import scipy.sparse as sp
import torch

from cora_tpu_torch.graph.data import ProblemData, torch_dtype


@dataclasses.dataclass
class BandedFactorHost:
    """Host-side factorization products (numpy)."""

    q: int  # scan block size (2(d+1) after LAPACK banded factorization)
    n_blocks: int  # number of scan blocks (ceil(band_len / q))
    band_len: int  # true band length n·(d+1) before block padding
    perm: np.ndarray  # (N,) permuted index -> original index
    inv_perm: np.ndarray  # (N,) original index -> permuted index
    L: np.ndarray  # (n, q, q) diagonal Cholesky blocks (lower)
    M: np.ndarray  # (n, q, q) subdiagonal blocks; M[0] = 0
    Linv: np.ndarray  # (n, q, q)
    s_sph: np.ndarray  # (m,) sphere pivots
    BinvC: np.ndarray  # (n*q, l) solved landmark columns
    cap_inv: np.ndarray  # (l, l) inverse of the Woodbury capacitance
    C: np.ndarray  # (n*q, l) landmark coupling (dense, l is tiny)
    E: np.ndarray  # (l, l)
    n_dropped: int  # out-of-band entries folded into the diagonal
    lam: float  # regularization actually used
    cb: np.ndarray | None = None  # LAPACK banded Cholesky factor of B
    # (lower form) — kept for host-side solves (float64 polish precon)
    # whether the factored matrix couples sphere rows to the band (False
    # for BlockCholesky, whose sphere block is standalone diagonal)
    sphere_coupled: bool = True
    bandwidth: int = 0  # scalar bandwidth of the band under the ordering


def pose_ordering(pd: ProblemData) -> np.ndarray:
    """Fill-reducing ordering of the pose blocks (reverse Cuthill–McKee).

    The band structure couples pose i to pose j through odometry /
    loop-closure edges and through sphere-eliminated pose↔pose range
    edges. For single-robot chains RCM reproduces the natural order; for
    multi-robot datasets with inter-robot ranges (tiers, mrclam) it
    interleaves the robots so that cross-robot couplings land near the
    diagonal instead of Θ(n) away.
    """
    import scipy.sparse.csgraph as csgraph

    n = pd.n
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rows, cols = [], []

    def add(i, j):
        keep = (i < n) & (j < n) & (i != j)
        rows.append(np.asarray(i)[keep])
        cols.append(np.asarray(j)[keep])

    if pd.num_rot_edges:
        add(np.asarray(pd.rot_i), np.asarray(pd.rot_j))
    if pd.num_pose_meas:
        add(np.asarray(pd.pm_ti), np.asarray(pd.pm_tj))
    if pd.m:
        add(np.asarray(pd.rng_ti), np.asarray(pd.rng_tj))
    if not rows:
        return np.arange(n, dtype=np.int64)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    A = sp.csr_matrix(
        (np.ones(len(r)), (r, c)), shape=(n, n)
    )
    A = A + A.T
    order = csgraph.reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True)
    return np.asarray(order, dtype=np.int64)


def build_permutation(pd: ProblemData, order: np.ndarray | None = None):
    """π interleaving rotation and translation rows per pose (in the given
    pose order); landmarks last.

    Returns (perm, inv_perm) with `perm[k]` = original row of permuted row k.
    The permuted layout is [pose blocks (n·(d+1)) | landmarks (l)]; sphere
    rows are excluded (eliminated separately).
    """
    d, n, l, m = pd.d, pd.n, pd.l, pd.m
    q = d + 1
    rot0 = 0
    tr0 = n * d + m  # original index of first pose translation
    lm0 = tr0 + n
    if order is None:
        order = np.arange(n, dtype=np.int64)

    perm = np.empty(n * q + l, dtype=np.int64)
    if n:
        blocks = perm[: n * q].reshape(n, q)
        blocks[:, :d] = rot0 + order[:, None] * d + np.arange(d)[None, :]
        blocks[:, d] = tr0 + order
    perm[n * q:] = np.arange(lm0, lm0 + l)

    inv_perm = np.empty(pd.size, dtype=np.int64)
    inv_perm[:] = -1
    inv_perm[perm] = np.arange(n * q + l)
    return perm, inv_perm


def _to_banded_lower(B: sp.spmatrix, bw: int):
    """Lower-banded LAPACK storage ab[k, c] = B[c+k, c], 0 ≤ k ≤ bw.

    Out-of-band entries are folded onto both diagonal entries (|a_ij| added,
    keeping the matrix SPD — ILU-style) and counted.
    """
    N = B.shape[0]
    Bc = sp.tril(B).tocoo()
    k = Bc.row - Bc.col
    ab = np.zeros((bw + 1, N))
    in_band = k <= bw
    np.add.at(ab, (k[in_band], Bc.col[in_band]), Bc.data[in_band])
    n_dropped = int((~in_band).sum())
    if n_dropped:
        r, c = Bc.row[~in_band], Bc.col[~in_band]
        v = np.abs(Bc.data[~in_band])
        np.add.at(ab, (np.zeros_like(r), r), v)
        np.add.at(ab, (np.zeros_like(c), c), v)
    return ab, n_dropped


def _blocks_from_banded_cholesky(cb: np.ndarray, w: int):
    """Scalar banded Cholesky factor → block-bidiagonal (nb, w, w) blocks.

    A lower-triangular banded L with bandwidth ≤ w−1, partitioned into w×w
    blocks, has only diagonal (lower-triangular) and first-subdiagonal
    blocks — the shape the doubling-scan solve consumes.
    Padding rows get unit diagonal (inert with zero RHS).
    """
    bw1, N = cb.shape
    nb = -(-N // w) if N else 0
    Ldiag = np.zeros((nb, w, w))
    Lsub = np.zeros((nb, w, w))
    for k in range(bw1):
        if N - k <= 0:
            break
        c = np.arange(N - k)
        r = c + k
        vals = cb[k, : N - k]
        bi, bj = r // w, c // w
        same = bi == bj
        Ldiag[bi[same], r[same] % w, c[same] % w] = vals[same]
        sub = bi == bj + 1
        Lsub[bi[sub], r[sub] % w, c[sub] % w] = vals[sub]
    pad = np.arange(N, nb * w)
    Ldiag[pad // w, pad % w, pad % w] = 1.0
    return Ldiag, Lsub


def banded_spd_factor(B: sp.spmatrix, C: np.ndarray, bw: int, w: int,
                      require_exact: bool = False):
    """Factor the SPD matrix [[B, C], [Cᵀ, E]]'s band part with LAPACK
    `cholesky_banded` and solve the Woodbury columns B⁻¹C.

    Returns (Ldiag, Lsub, Linv, BinvC, n_dropped). Raises
    `np.linalg.LinAlgError` if B is not positive definite (LAPACK info>0),
    `ValueError` if `require_exact` and the band drops entries.
    """
    import scipy.linalg as sla

    nq = B.shape[0]
    if nq == 0:
        z = np.zeros((0, w, w))
        return z, z, z, np.zeros((0, C.shape[1])), 0, None
    bw = min(bw, nq - 1)
    ab, n_dropped = _to_banded_lower(B, bw)
    if require_exact and n_dropped:
        raise ValueError(f"{n_dropped} out-of-band entries; factorization inexact")
    try:
        cb = sla.cholesky_banded(ab, lower=True)
    except sla.LinAlgError as e:
        raise np.linalg.LinAlgError(str(e))
    BinvC = (
        sla.cho_solve_banded((cb, True), C) if C.shape[1] else
        np.zeros((nq, 0))
    )
    Ldiag, Lsub = _blocks_from_banded_cholesky(cb, w)
    Linv = np.linalg.inv(Ldiag)
    return Ldiag, Lsub, Linv, BinvC, n_dropped, cb


def factor_banded(
    problem,
    pd: ProblemData,
    M_sparse: sp.spmatrix,
    lam: float,
    require_exact: bool = False,
    order: np.ndarray | None = None,
) -> BandedFactorHost:
    """Factor M = (given sparse symmetric matrix) + λI with the
    sphere-elimination → banded → Woodbury pipeline.

    Raises np.linalg.LinAlgError if a pivot fails (⇒ M+λI not PD), which
    the PSD certification fast path uses as its decision procedure.
    If `require_exact`, raises ValueError when out-of-band entries would
    be dropped (the factorization would be inexact).
    """
    d, n, l, m = pd.d, pd.n, pd.l, pd.m
    q = d + 1
    N = pd.size
    M_all = (M_sparse + lam * sp.eye(N, format="csr")).tocsr()

    # the permutation depends only on the graph structure — cache it on the
    # problem (certification calls factor_banded once per staircase level);
    # an explicit `order` (e.g. identity for the fused-kernel tile layout)
    # bypasses the RCM ordering and the cache
    if order is not None:
        perm, inv_perm = build_permutation(pd, order=order)
    else:
        cached = getattr(problem, "_band_perm_cache", None) if problem is not None else None
        if cached is not None and cached[0] == pd.size:
            perm, inv_perm = cached[1], cached[2]
        else:
            perm, inv_perm = build_permutation(pd, order=pose_ordering(pd))
            if problem is not None:
                problem._band_perm_cache = (pd.size, perm, inv_perm)

    sph0 = n * d
    sph_idx = np.arange(sph0, sph0 + m)
    bl_idx = perm  # band ∪ landmarks, permuted order

    # ---- sphere elimination ----
    s_sph = M_all.diagonal()[sph_idx] if m else np.zeros(0)
    if m and (s_sph <= 0).any():
        raise np.linalg.LinAlgError("non-positive sphere pivot")
    M_bl = M_all[bl_idx][:, bl_idx].tocsr()
    if m:
        C_s = M_all[bl_idx][:, sph_idx].tocsr()  # coupling band∪lm × spheres
        M_bl = (M_bl - C_s @ sp.diags(1.0 / s_sph) @ C_s.T).tocsr()

    # ---- split band | landmarks ----
    nq = n * q
    B = M_bl[:nq, :nq]
    C = M_bl[:nq, nq:].toarray() if l else np.zeros((nq, 0))
    E = M_bl[nq:, nq:].toarray() if l else np.zeros((0, 0))

    # measure the actual scalar bandwidth under the RCM pose ordering
    # (2q−1 for pure chains; wider when inter-robot couplings exist),
    # cap it to keep the scan blocks small, and pick the scan block size
    # w ≥ bw+1 so the Cholesky factor is exactly block-bidiagonal
    Bc = sp.tril(B).tocoo()
    bw_actual = int((Bc.row - Bc.col).max()) if Bc.nnz else 0
    BW_CAP = 96
    bw = min(max(bw_actual, 2 * q - 1), BW_CAP)
    if require_exact and bw_actual > BW_CAP:
        raise ValueError(
            f"bandwidth {bw_actual} exceeds cap {BW_CAP}; factorization inexact"
        )
    w = -(-(bw + 1) // q) * q  # round up to a multiple of q
    L, Msub, Linv, BinvC, n_dropped, cb = banded_spd_factor(
        B.tocsr(), C, bw, w, require_exact=require_exact
    )

    # ---- Woodbury for landmark columns ----
    if l:
        cap = E - C.T @ BinvC
        cap = 0.5 * (cap + cap.T)
        cap_chol = np.linalg.cholesky(cap)  # raises if not PD
        cap_inv = np.linalg.inv(cap_chol.T) @ np.linalg.inv(cap_chol)
    else:
        cap_inv = np.zeros((0, 0))

    return BandedFactorHost(
        q=w, n_blocks=L.shape[0], band_len=nq,
        perm=perm, inv_perm=inv_perm,
        L=L, M=Msub, Linv=Linv, s_sph=s_sph,
        BinvC=BinvC, cap_inv=cap_inv, C=C, E=E,
        n_dropped=n_dropped, lam=lam, cb=cb, bandwidth=bw_actual,
    )


def host_banded_solve(pd: ProblemData, F: BandedFactorHost, V: np.ndarray) -> np.ndarray:
    """Host float64 solve M⁻¹V from a BandedFactorHost — the numpy mirror
    of the chain plan's doubling-scan solve using LAPACK's banded triangular solves
    (`scipy.linalg.cho_solve_banded`). Used as the float64-polish
    preconditioner where SuperLU would cost ~8 ms per apply."""
    import scipy.linalg as sla

    V = np.asarray(V, np.float64)
    m = pd.m
    sph0 = pd.rot_size
    tr0 = sph0 + m
    nq = F.band_len
    r = V.shape[1]

    if m:
        c_val = (
            np.asarray(pd.rng_omega, np.float64)
            * np.asarray(pd.rng_r, np.float64)
            * (1.0 if F.sphere_coupled else 0.0)
        )
        rng_ti = np.asarray(pd.rng_ti)
        rng_tj = np.asarray(pd.rng_tj)
        w_sph = V[sph0:tr0] / F.s_sph[:, None]
        corr = np.zeros((pd.num_translations, r))
        cw = c_val[:, None] * w_sph
        np.subtract.at(corr, rng_ti, cw)
        np.add.at(corr, rng_tj, cw)
        full = np.concatenate([V[:sph0], np.zeros((m, r)), V[tr0:] - corr])
    else:
        full = V.copy()

    v_bl = full[F.perm]
    rhs_b, rhs_lm = v_bl[:nq], v_bl[nq:]
    y1 = sla.cho_solve_banded((F.cb, True), rhs_b) if nq else rhs_b
    if F.C.shape[1]:
        y2 = F.cap_inv @ (rhs_lm - F.C.T @ y1)
        x_b = y1 - F.BinvC @ y2
        x_lm = y2
    else:
        x_b, x_lm = y1, rhs_lm
    out = np.zeros((pd.size, r))
    out[F.perm] = np.concatenate([x_b, x_lm], axis=0)

    if m:
        x_tr = out[tr0:]
        out[sph0:tr0] = (
            V[sph0:tr0] - c_val[:, None] * (x_tr[rng_tj] - x_tr[rng_ti])
        ) / F.s_sph[:, None]
    return out


def estimate_spectral_norm(Q: sp.spmatrix, tol: float = 1e-2) -> float:
    """‖Q‖₂ estimate (reference uses a 4-block LOBPCG on −Q,
    `CORA_problem.cpp:556-578`).

    Deterministically seeded: the estimate sets the preconditioner's
    regularization λ = ‖Q‖₂/(κ−1), and an ARPACK default (random) start
    vector would make λ — and with it the entire float32 staircase
    trajectory — vary run to run."""
    from scipy.sparse.linalg import eigsh

    try:
        v0 = np.random.default_rng(0).standard_normal(Q.shape[0])
        w = eigsh(Q, k=1, which="LA", tol=tol, v0=v0,
                  return_eigenvectors=False)
        return float(abs(w[0]))
    except Exception:
        # power-iteration fallback
        rng = np.random.default_rng(0)
        x = rng.standard_normal(Q.shape[0])
        for _ in range(50):
            x = Q @ x
            x /= np.linalg.norm(x)
        return float(abs(x @ (Q @ x)))


def doubling_propagators(F: BandedFactorHost):
    """(levels, AF): the band's forward solve as a Hillis–Steele doubling
    scan. With A_i = −L_i⁻¹ M_i the recurrence u_i = A_i u_{i−1} + L_i⁻¹ b_i
    takes ⌈log₂ nb⌉ levels, level k adding P_i u_{i−2ᵏ} with the propagator
    P_i = A_i ⋯ A_{i−2ᵏ+1}, stored as AF[k, i] for i ≥ 2ᵏ (host float64)."""
    nb, w = F.Linv.shape[0], F.q
    levels = int(np.ceil(np.log2(nb))) if nb > 1 else 0
    Ak = -np.einsum("nab,nbc->nac", F.Linv, F.M)
    AF = np.zeros((max(levels, 1), nb, w, w))
    for k in range(levels):
        s = 1 << k
        AF[k, s:] = Ak[s:]
        if s < nb:
            An = Ak.copy()
            An[s:] = np.einsum("nab,nbc->nac", Ak[s:], Ak[:nb - s])
            Ak = An
    return levels, AF


def device_factor(pd: ProblemData, F: BandedFactorHost, dtype=None) -> dict:
    """The factor as tensors on `pd`'s device for `banded_apply`, with the
    doubling propagators formed once in float64 and cast to `dtype`
    (`pd`'s by default)."""
    dt = pd.dtype() if dtype is None else torch_dtype(dtype)
    levels, AF = doubling_propagators(F)
    # band ∪ landmark rows index the state without its sphere rows
    m, tr0 = pd.m, pd.rot_size + pd.m
    perm_src = np.where(F.perm >= tr0, F.perm - m, F.perm)
    inv_src = np.empty_like(perm_src)
    inv_src[perm_src] = np.arange(len(perm_src))
    dev = pd.device

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dev, dt)

    c_val = (pd.rng_omega * pd.rng_r).to(dt) if F.sphere_coupled else \
        torch.zeros(m, dtype=dt, device=dev)
    return dict(
        Linv=T(F.Linv), AF=T(AF), levels=levels,
        perm=torch.as_tensor(perm_src, device=dev),
        inv_perm=torch.as_tensor(inv_src, device=dev),
        s_sph=T(F.s_sph), c_val=c_val, C=T(F.C), BinvC=T(F.BinvC),
        cap_inv=T(F.cap_inv), bandwidth=F.bandwidth,
    )


def _solve_band(fac: dict, b: torch.Tensor) -> torch.Tensor:
    """B⁻¹b for b (nb, w, r): the forward doubling scan L⁻¹ and its exact
    adjoint, so B⁻¹ = L⁻ᵀL⁻¹ stays symmetric PSD whatever the rounding of
    the stored propagators."""
    Linv, AF = fac["Linv"], fac["AF"]
    nb = Linv.shape[0]
    u = Linv @ b
    for k in range(fac["levels"]):
        s = 1 << k
        u[s:] += AF[k, s:] @ u[:nb - s]
    for k in reversed(range(fac["levels"])):
        s = 1 << k
        u[:nb - s] += AF[k, s:].transpose(1, 2) @ u[s:]
    return Linv.transpose(1, 2) @ u


def banded_apply(pd: ProblemData, fac: dict, V: torch.Tensor) -> torch.Tensor:
    """V ↦ M⁻¹V from a `device_factor`: sphere elimination → permuted band
    solve → Woodbury landmark correction → sphere back-substitution."""
    Linv = fac["Linv"]
    V = V.to(Linv.dtype)
    nb, w = Linv.shape[:2]
    r = V.shape[1]
    m, sph0 = pd.m, pd.rot_size
    tr0 = sph0 + m
    nq = fac["C"].shape[0]
    if m:
        cw = fac["c_val"][:, None] * (V[sph0:tr0] / fac["s_sph"][:, None])
        v_tr = V[tr0:] - pd.incidence.rng(torch.cat([-cw, cw]))
    else:
        v_tr = V[tr0:]
    v_bl = torch.cat([V[:sph0], v_tr])[fac["perm"]]
    b = v_bl.new_zeros((nb * w, r))
    b[:nq] = v_bl[:nq]
    y1 = _solve_band(fac, b.view(nb, w, r)).reshape(nb * w, r)[:nq]
    if fac["C"].shape[1]:
        y2 = fac["cap_inv"] @ (v_bl[nq:] - fac["C"].T @ y1)
        x_bl = torch.cat([y1 - fac["BinvC"] @ y2, y2])
    else:
        x_bl = torch.cat([y1, v_bl[nq:]])
    out = x_bl[fac["inv_perm"]]  # the state without its sphere rows
    if not m:
        return out
    x_tr = out[sph0:]
    xs = (V[sph0:tr0] - fac["c_val"][:, None] * (
        x_tr[pd.rng_tj] - x_tr[pd.rng_ti])) / fac["s_sph"][:, None]
    return torch.cat([out[:sph0], xs, out[sph0:]])


def make_device_apply(pd: ProblemData, F: BandedFactorHost, dtype=None):
    """The factorization as a `PrecondOp` on `pd`'s device."""
    from cora_tpu_torch.precond import PrecondOp

    return PrecondOp(banded_apply, device_factor(pd, F, dtype), pd)


def banded_cholesky_preconditioner(problem, pd: ProblemData,
                                   max_cond: float = 1e6, dtype=None):
    """The RegularizedCholesky preconditioner (Q + λI)⁻¹ with
    λ = ‖Q‖₂/(κ−1) (reference `CORA_problem.cpp:590-591`)."""
    Q = problem.data_matrix()
    lam = estimate_spectral_norm(Q) / (max_cond - 1.0)
    F = factor_banded(problem, problem.device_data(np.float64, "cpu"), Q, lam)
    apply = make_device_apply(pd, F, dtype)
    apply.n_dropped = F.n_dropped
    return apply


def block_cholesky_preconditioner(problem, pd: ProblemData, dtype=None,
                                  reg: float = 1e-3):
    """The reference's BlockCholesky: one factor per variable type of
    Q + 1e-3·I — rotations, unit spheres, translations — with the
    cross-type blocks dropped (`src/CORA_problem.cpp:513-543`), on the
    same banded + Woodbury machinery."""
    Q = problem.data_matrix().tocoo()
    nd = pd.rot_size
    type_of = np.digitize(np.arange(pd.size), [nd, nd + pd.m])
    mask = type_of[Q.row] == type_of[Q.col]
    Q_bd = sp.csr_matrix((Q.data[mask], (Q.row[mask], Q.col[mask])),
                         shape=Q.shape)
    F = dataclasses.replace(
        factor_banded(None, problem.device_data(np.float64, "cpu"), Q_bd,
                      reg), sphere_coupled=False)
    apply = make_device_apply(pd, F, dtype)
    apply.n_dropped = F.n_dropped
    return apply
