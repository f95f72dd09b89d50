"""The chain plan and the plain PyTorch versions of the kernels' math.

Every operation of the TNT hot loop acts on the canonical (N, r) row-major
state ``[n·d rotation rows | m bearing rows | n pose translations |
l landmark translations]``. For an odometry chain (every rel-pose edge
joins pose g to g+1, ranges go pose → landmark) the data matrix Q is fully
described by per-pose edge coefficients and a per-range table, and the
banded factor of Q + λI (identity pose ordering, pose-pair blocks) is
applied as a log-depth doubling scan. `build_chain_plan` derives all of
that on the host, once per problem; the functions below are the plain
versions of the device functions in `csrc/chain_ops.cuh`, with the same
names and semantics:

  * `qv`               — Q·Y in factored edge form
                         (reference `CORA_problem.cpp:742-757`);
  * `tangent_project`  — blockwise projection onto T_Y
                         (reference `CORA_problem.cpp:782-820`);
  * `hvp`              — Riemannian Hessian-vector product
                         (reference `CORA_problem.cpp:822-867`);
  * `precon_solve`     — (Q + λI)⁻¹V: sphere elimination → banded doubling
                         scan with its exact adjoint → Woodbury landmark
                         correction → sphere back-substitution;
  * `project_manifold` / `retract` — d=2 closed-form polar with a
                         singular-block shift, d=3 QDWH, sphere rows
                         normalised (reference `CORA_problem.cpp:905-938`).

They run in float32 or float64 on any device, vectorised over poses with
reshapes and padded gathers. The range terms are summed per pose and per
landmark by a gather and a fixed-order `sum`, not `index_add_`, whose CUDA
atomics would make two float64 polishes from one point differ in the last
bits — enough to send the float32 staircase after it down another path.
The CPU runs them, the tests hold them against
the JAX package, and on the card they are what each kernel is compared
with. The float64 polish (`cora_tpu_torch.solve.polish`) runs them on a
float64 plan.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cora_tpu_torch.graph.data import ProblemData, torch_dtype

S_MAX = 8  # max range slots per pose the kernels support
L_MAX = 16  # max landmarks
R_MAX = 10  # max rank the kernels support


def plan_supported(pd: ProblemData) -> str | None:
    """None if the chain plan covers this problem, else a reason.

    Coverage: (masked-)chain graphs — every rel-pose edge connects pose i
    to i+1, ranges go pose → landmark, bounded slots/landmarks.
    """
    if pd.d not in (2, 3):
        return f"d={pd.d} unsupported"
    if pd.n < 2:
        return "fewer than 2 poses"
    rot_i = np.asarray(pd.rot_i.cpu())
    rot_j = np.asarray(pd.rot_j.cpu())
    if pd.num_rot_edges:
        if not (rot_j == rot_i + 1).all():
            return "non-chain rotation edge"
        if len(np.unique(rot_i)) != len(rot_i):
            return "duplicate rotation chain edge"
    pm_ti = np.asarray(pd.pm_ti.cpu())
    pm_tj = np.asarray(pd.pm_tj.cpu())
    if pd.num_pose_meas:
        if not ((pm_tj == pm_ti + 1) & (pm_ti < pd.n) & (pm_tj < pd.n)).all():
            return "non-chain translational measurement"
        if len(np.unique(pm_ti)) != len(pm_ti):
            return "duplicate translational chain edge"
    if pd.m:
        ti = np.asarray(pd.rng_ti.cpu())
        tj = np.asarray(pd.rng_tj.cpu())
        if not (ti < pd.n).all():
            return "range from non-pose"
        if not (tj >= pd.n).all():
            return "pose-to-pose range"
        slots = np.bincount(ti, minlength=pd.n).max()
        if slots > S_MAX:
            return f"{slots} ranges on one pose (> {S_MAX})"
    if pd.l > L_MAX:
        return f"{pd.l} landmarks (> {L_MAX})"
    return None


def qdwh_weights(l0: float, iters: int = 8):
    """The QDWH (a, b, c) weight schedule for a σ_min/σ_max lower bound l0
    (copied from the JAX package's `ops/manifolds.py`). Data-independent,
    so it is computed once in Python floats."""
    ws = []
    l = l0
    for _ in range(iters):
        l2 = min(max(l * l, 1e-300), 1.0)
        dd = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
        sq = math.sqrt(1.0 + dd)
        a = sq + 0.5 * math.sqrt(
            max(8.0 - 4.0 * dd + 8.0 * (2.0 - l2) / (l2 * sq), 0.0))
        b = 0.25 * (a - 1.0) ** 2
        c = a + b - 1.0
        ws.append((a, b, c))
        l = min(l * (a + b * l2) / (1.0 + c * l2), 1.0)
    return ws


def qdwh_l0(dtype: torch.dtype) -> float:
    return 1e-4 if dtype == torch.float32 else 1e-8


@dataclasses.dataclass
class ChainPlan:
    """Host-built constants of one problem, as tensors on one device.

    Edge g is the chain edge from pose g to g+1 (zero where absent and at
    g = n−1). The band is the pose-pair blocking of the banded factor:
    block c holds rows [R_2c (d), t_2c, R_2c+1 (d), t_2c+1], w = 2(d+1).
    """

    d: int
    n: int
    l: int
    m: int
    N: int
    nb: int  # pose pairs = ceil(n/2)
    w: int  # band block = 2(d+1)
    S: int  # range slots per pose
    levels: int  # doubling-scan levels = ceil(log2(nb))
    lam: float  # regularization λ = ‖Q‖₂/(κ−1)
    dtype: torch.dtype
    device: torch.device
    kap: torch.Tensor  # (n,) rotation precision of edge g
    R: torch.Tensor  # (n, d, d) measured rotation of edge g
    tau: torch.Tensor  # (n,) translation precision of edge g
    tvec: torch.Tensor  # (n, d) measured translation of edge g
    rng_pose: torch.Tensor  # (m,) int64 pose of range e
    rng_lm: torch.Tensor  # (m,) int64 landmark of range e
    rr: torch.Tensor  # (m,) measured distance
    om: torch.Tensor  # (m,) range precision
    spiv_inv: torch.Tensor  # (m,) 1 / sphere pivot of the factor
    cval: torch.Tensor  # (m,) ω·r sphere↔translation coupling
    slot: torch.Tensor  # (n, S) int32 range index of pose g's slot, −1 empty
    lm_ptr: torch.Tensor  # (l+1,) int32 ranges of landmark k are
    lm_rng: torch.Tensor  # (m,) int32  lm_rng[lm_ptr[k]:lm_ptr[k+1]]
    slot_rows: torch.Tensor  # (n, S) int64 `slot` with empty slots → m
    lm_rows: torch.Tensor  # (l, K) int64 ranges of landmark k, padded with m
    Linv: torch.Tensor  # (nb, w, w) inverse diagonal factor blocks
    AF: torch.Tensor  # (levels, nb, w, w) forward doubling propagators
    C: torch.Tensor  # (nb, w, l) Woodbury landmark columns
    BinvC: torch.Tensor  # (nb, w, l) B⁻¹C
    capinv: torch.Tensor  # (l, l) inverse capacitance
    qdwh: torch.Tensor  # (8, 3) per-iteration (c, b/c, a − b/c) for d=3

    @property
    def nd(self) -> int:
        return self.n * self.d


def build_chain_plan(problem, dtype=np.float32, device="cpu",
                     max_cond: float = 1e6,
                     lam: float | None = None) -> ChainPlan:
    """All constants of the chain ops for one problem (host numpy/scipy,
    then one upload). The banded factor uses the identity pose ordering and
    λ = ‖Q‖₂/(κ−1), as the JAX package's `build_tile_plan` does
    (reference `CORA_problem.cpp:590-591`). Coefficients come from the
    problem data in `dtype`, so a float32 plan carries float32-rounded
    measurements like the float32 solve."""
    from cora_tpu_torch.precond.banded import (
        estimate_spectral_norm,
        factor_banded,
    )

    pd = problem.device_data(dtype=dtype, device="cpu")
    reason = plan_supported(pd)
    if reason is not None:
        raise NotImplementedError(f"chain plan unsupported: {reason}")

    d, n, l, m = pd.d, pd.n, pd.l, pd.m
    q, w = d + 1, 2 * (d + 1)
    nb = (n + 1) // 2
    levels = max(int(math.ceil(math.log2(nb))), 0) if nb > 1 else 0
    f = lambda x: np.asarray(x, np.float64)  # noqa: E731

    kap = np.zeros(n)
    R = np.zeros((n, d, d))
    tau = np.zeros(n)
    tvec = np.zeros((n, d))
    if pd.num_rot_edges:
        g = np.asarray(pd.rot_i)
        kap[g] = f(pd.rot_kappa)
        R[g] = f(pd.rot_R)
    if pd.num_pose_meas:
        g = np.asarray(pd.pm_ti)
        tau[g] = f(pd.pm_tau)
        tvec[g] = f(pd.pm_t)

    ti = np.asarray(pd.rng_ti, np.int64)
    tj = np.asarray(pd.rng_tj, np.int64)
    S = max(int(np.bincount(ti, minlength=n).max()) if m else 1, 1)
    slot = np.full((n, S), -1, np.int32)
    fill = np.zeros(n, np.int64)
    for e in np.argsort(ti, kind="stable"):
        slot[ti[e], fill[ti[e]]] = e
        fill[ti[e]] += 1
    rng_lm = tj - n
    lm_rng = np.argsort(rng_lm, kind="stable").astype(np.int32)
    lm_ptr = np.zeros(l + 1, np.int32)
    lm_ptr[1:] = np.cumsum(np.bincount(rng_lm, minlength=l))
    # the same tables as gather indices into a zero-padded (m + 1)-row array
    slot_rows = np.where(slot >= 0, slot, m).astype(np.int64)
    K = int(np.diff(lm_ptr).max()) if l else 0
    lm_rows = np.full((l, K), m, np.int64)
    for k in range(l):
        lm_rows[k, :lm_ptr[k + 1] - lm_ptr[k]] = lm_rng[lm_ptr[k]:lm_ptr[k + 1]]

    Q = problem.data_matrix()
    if lam is None:
        lam = estimate_spectral_norm(Q) / (max_cond - 1.0)
    F = factor_banded(None, pd, Q, lam, order=np.arange(n, dtype=np.int64))
    if F.q != w:
        raise ValueError(f"factor block {F.q} != pose-pair width {w}")
    Linv = F.Linv
    A = -np.einsum("nab,nbc->nac", Linv, F.M)
    # doubling propagators: level k carries A_c ⋯ A_{c−2^k+1} for c ≥ 2^k
    AF = np.zeros((max(levels, 1), nb, w, w))
    Ak = A.copy()
    for k in range(levels):
        s = 1 << k
        AF[k, s:] = Ak[s:]
        if s < nb:
            An = Ak.copy()
            An[s:] = np.einsum("nab,nbc->nac", Ak[s:], Ak[:nb - s])
            Ak = An
    C = np.zeros((nb * w, l))
    BinvC = np.zeros((nb * w, l))
    if l:
        C[:F.band_len] = F.C
        BinvC[:F.band_len] = F.BinvC
    capinv = F.cap_inv if l else np.zeros((0, 0))
    qd = [(c, b / c, a - b / c)
          for a, b, c in qdwh_weights(qdwh_l0(torch_dtype(dtype)), 8)]

    tdt = torch_dtype(dtype)
    dev = torch.device(device)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dev, tdt)

    def I(x):  # noqa: E743
        return torch.as_tensor(x).to(dev)

    return ChainPlan(
        d=d, n=n, l=l, m=m, N=pd.size, nb=nb, w=w, S=S, levels=levels,
        lam=float(lam), dtype=tdt, device=dev,
        kap=T(kap), R=T(R), tau=T(tau), tvec=T(tvec),
        rng_pose=I(ti), rng_lm=I(rng_lm), rr=T(f(pd.rng_r)),
        om=T(f(pd.rng_omega)), spiv_inv=T(1.0 / F.s_sph if m else np.zeros(0)),
        cval=T(f(pd.rng_omega) * f(pd.rng_r)),
        slot=I(slot), lm_ptr=I(lm_ptr), lm_rng=I(lm_rng),
        slot_rows=I(slot_rows), lm_rows=I(lm_rows),
        Linv=T(Linv), AF=T(AF), C=T(C.reshape(nb, w, l)),
        BinvC=T(BinvC.reshape(nb, w, l)), capinv=T(capinv), qdwh=T(qd),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions of the device functions (canonical (N, r) state)
# ---------------------------------------------------------------------------


def split(plan: ChainPlan, Y: torch.Tensor):
    """(..., N, r) → views (rot (..., n, d, r), sph (..., m, r),
    tr (..., n, r), lm (..., l, r))."""
    nd, m, n = plan.nd, plan.m, plan.n
    return (Y[..., :nd, :].unflatten(-2, (n, plan.d)), Y[..., nd:nd + m, :],
            Y[..., nd + m:nd + m + n, :], Y[..., nd + m + n:, :])


def join(rot, sph, tr, lm) -> torch.Tensor:
    return torch.cat([rot.flatten(-3, -2), sph, tr, lm], dim=-2)


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _per_pose(plan: ChainPlan, x: torch.Tensor) -> torch.Tensor:
    """(m, r) range rows → (n, r): the sum over each pose's range slots."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return pad[plan.slot_rows].sum(1)


def _per_landmark(plan: ChainPlan, x: torch.Tensor) -> torch.Tensor:
    """(m, r) range rows → (l, r): the sum over each landmark's ranges."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return pad[plan.lm_rows].sum(1)


def dot(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """⟨A, B⟩ = tr(AᵀB), a 0-d tensor."""
    return (A * B).sum()


def qv(plan: ChainPlan, Y: torch.Tensor) -> torch.Tensor:
    """Q·Y from the chain coefficients."""
    rot, sph, tr, lm = split(plan, Y)
    out_rot = torch.zeros_like(rot)
    out_tr = torch.zeros_like(tr)
    out_lm = torch.zeros_like(lm)
    Yi, Yj = rot[:-1], rot[1:]
    kap = plan.kap[:-1, None, None]
    R = plan.R[:-1]
    # rotation connection Laplacian: κ(Y_g − R Y_g+1), κ(Y_g+1 − Rᵀ Y_g)
    out_rot[:-1] += kap * (Yi - R @ Yj)
    out_rot[1:] += kap * (Yj - R.transpose(1, 2) @ Yi)
    # translation edge: u = t_g+1 − t_g − t_eᵀ Y_g, w = τ u
    tvec = plan.tvec[:-1]
    u = tr[1:] - tr[:-1] - (tvec[:, :, None] * Yi).sum(1)
    wv = plan.tau[:-1, None] * u
    out_rot[:-1] -= tvec[:, :, None] * wv[:, None, :]
    out_tr[:-1] -= wv
    out_tr[1:] += wv
    # ranges: v = r y + t_lm − t_pose
    if plan.m:
        v = plan.rr[:, None] * sph + lm[plan.rng_lm] - tr[plan.rng_pose]
        wr = plan.om[:, None] * v
        out_sph = plan.rr[:, None] * wr
        out_tr -= _per_pose(plan, wr)
        out_lm += _per_landmark(plan, wr)
    else:
        out_sph = sph.clone()
    return join(out_rot, out_sph, out_tr, out_lm)


def tangent_project(plan: ChainPlan, Y: torch.Tensor,
                    V: torch.Tensor) -> torch.Tensor:
    """V − sym(Y Vᵀ) Y per rotation block, v − ⟨y, v⟩y per bearing row."""
    Yr, Ys, _, _ = split(plan, Y)
    Vr, Vs, Vt, Vl = split(plan, V)
    Pr = Vr - _sym(Yr @ Vr.transpose(1, 2)) @ Yr
    Ps = Vs - (Ys * Vs).sum(1, keepdim=True) * Ys
    return join(Pr, Ps, Vt, Vl)


def hvp(plan: ChainPlan, Y: torch.Tensor, nablaF: torch.Tensor,
        dotY: torch.Tensor) -> torch.Tensor:
    """Proj_TY(Q Ẏ − Weingarten terms)."""
    H = qv(plan, dotY)
    Yr, Ys, _, _ = split(plan, Y)
    Gr, Gs, _, _ = split(plan, nablaF)
    dr, ds, _, _ = split(plan, dotY)
    Hr, Hs, Ht, Hl = split(plan, H)
    Hr = Hr - _sym(Yr @ Gr.transpose(1, 2)) @ dr
    Hs = Hs - (Gs * Ys).sum(1, keepdim=True) * ds
    return tangent_project(plan, Y, join(Hr, Hs, Ht, Hl))


def _solve_B(plan: ChainPlan, b: torch.Tensor) -> torch.Tensor:
    """B⁻¹b on the pose-pair band (nb, w, r): the forward doubling network
    L̃⁻¹ (Linv block matvec, then one propagator level per doubling) and
    its exact adjoint, so B⁻¹ = (L̃⁻¹)ᵀ L̃⁻¹ is symmetric PSD for the stored
    propagators whatever their rounding."""
    u = plan.Linv @ b
    nb = plan.nb
    for k in range(plan.levels):
        s = 1 << k
        u[s:] += plan.AF[k, s:] @ u[:nb - s]
    for k in reversed(range(plan.levels)):
        s = 1 << k
        u[:nb - s] += plan.AF[k, s:].transpose(1, 2) @ u[s:]
    return plan.Linv.transpose(1, 2) @ u


def precon_solve(plan: ChainPlan, V: torch.Tensor) -> torch.Tensor:
    """(Q + λI)⁻¹V: sphere elimination → banded solve → Woodbury landmark
    correction → sphere back-substitution."""
    d, n, nb, w, r = plan.d, plan.n, plan.nb, plan.w, V.shape[1]
    q = d + 1
    rot, sph, tr, lm = split(plan, V)
    band = V.new_zeros((2 * nb, q, r))
    band[:n, :d] = rot
    band[:n, d] = tr
    lm_rhs = lm.clone()
    if plan.m:
        cw = (plan.cval * plan.spiv_inv)[:, None] * sph
        band[:n, d] += _per_pose(plan, cw)
        lm_rhs -= _per_landmark(plan, cw)
    y1 = _solve_B(plan, band.view(nb, w, r))
    if plan.l:
        z = lm_rhs - torch.einsum("cek,cer->kr", plan.C, y1)
        x_lm = plan.capinv @ z
        x_b = y1 - torch.einsum("cek,kr->cer", plan.BinvC, x_lm)
    else:
        x_b, x_lm = y1, lm_rhs
    x = x_b.reshape(2 * nb, q, r)[:n]
    x_rot, x_tr = x[:, :d], x[:, d]
    if plan.m:
        x_sph = plan.spiv_inv[:, None] * (
            sph - plan.cval[:, None] * (x_lm[plan.rng_lm] - x_tr[plan.rng_pose]))
    else:
        x_sph = sph.clone()
    return join(x_rot, x_sph, x_tr, x_lm)


def project_manifold(plan: ChainPlan, A: torch.Tensor) -> torch.Tensor:
    """Blockwise metric projection: Stiefel polar per pose (closed form for
    d=2 with a trace-relative shift of singular blocks, QDWH for d=3),
    sphere rows normalised, translations unchanged. `A` is (N, r) or a
    batch (..., N, r) of states."""
    Ar, As, At, Al = split(plan, A)
    tiny = torch.finfo(A.dtype).tiny
    if plan.d == 2:
        G = Ar @ Ar.transpose(-1, -2)
        a, b, c = G[..., 0, 0], G[..., 0, 1], G[..., 1, 1]
        tr0 = a + c
        det0 = a * c - b * b
        shift = torch.where(det0 < 1e-6 * torch.clamp(tr0 * tr0, min=tiny),
                            1e-3 * tr0, torch.zeros_like(tr0))
        a = a + shift
        c = c + shift
        s = torch.sqrt(torch.clamp(a * c - b * b, min=tiny))
        t = torch.sqrt(torch.clamp(a + c + 2.0 * s, min=tiny))
        f = t / torch.clamp((a + s) * (c + s) - b * b, min=tiny)
        inv = torch.stack([torch.stack([f * (c + s), -f * b], -1),
                           torch.stack([-f * b, f * (a + s)], -1)], -2)
        Pr = inv @ Ar
    else:
        fro2 = (Ar * Ar).sum((-2, -1), keepdim=True)
        X = Ar / torch.sqrt(torch.clamp(fro2, min=tiny))
        for cw, bc, abc in plan.qdwh.tolist():
            Z = cw * (X @ X.transpose(-1, -2))
            Z = Z + torch.eye(3, dtype=A.dtype, device=A.device)
            X = bc * X + abc * _solve_3x3_spd(Z, X, tiny)
        Pr = X
    nrm = torch.sqrt((As * As).sum(-1, keepdim=True))
    Ps = As / torch.clamp(nrm, min=tiny)
    return join(Pr, Ps, At, Al)


def _solve_3x3_spd(Z, B, tiny):
    """Z⁻¹B for SPD 3×3 blocks via closed-form Cholesky and two unrolled
    triangular solves (stable for the badly scaled Z = I + cW of QDWH)."""
    z00, z01, z02 = Z[..., 0, 0, None], Z[..., 0, 1, None], Z[..., 0, 2, None]
    z11, z12, z22 = Z[..., 1, 1, None], Z[..., 1, 2, None], Z[..., 2, 2, None]
    l11 = torch.sqrt(torch.clamp(z00, min=tiny))
    l21 = z01 / l11
    l31 = z02 / l11
    l22 = torch.sqrt(torch.clamp(z11 - l21 * l21, min=tiny))
    l32 = (z12 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(z22 - l31 * l31 - l32 * l32, min=tiny))
    y1 = B[..., 0, :] / l11
    y2 = (B[..., 1, :] - l21 * y1) / l22
    y3 = (B[..., 2, :] - l31 * y1 - l32 * y2) / l33
    s3 = y3 / l33
    s2 = (y2 - l32 * s3) / l22
    s1 = (y1 - l21 * s2 - l31 * s3) / l11
    return torch.stack([s1, s2, s3], -2)


def retract(plan: ChainPlan, Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Projection-based retraction (reference `CORA_problem.cpp:936-938`)."""
    return project_manifold(plan, Y + V)


def random_initial_guess(pd: ProblemData, rank: int,
                         generator: torch.Generator, dtype=None,
                         device=None) -> torch.Tensor:
    """Random point on the manifold (reference `CORA_problem.cpp:1023-1028`):
    uniform in [−1, 1], Stiefel blocks projected by a float64 SVD (polar
    U Vᵀ, defined even for a singular block), bearing rows normalised.
    Draws on the CPU from `generator`, so a seed gives the same start on
    every device."""
    A = torch.rand((pd.size, rank), generator=generator,
                   dtype=torch.float64) * 2.0 - 1.0
    nd = pd.rot_size
    U, _, Vh = torch.linalg.svd(A[:nd].view(pd.n, pd.d, rank),
                                full_matrices=False)
    A[:nd] = (U @ Vh).reshape(nd, rank)
    if pd.m:
        sph = A[nd:nd + pd.m]
        A[nd:nd + pd.m] = sph / torch.clamp(
            sph.norm(dim=1, keepdim=True), min=1e-30)
    return A.to(device or pd.device, dtype or pd.dtype())
