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
  * `project_manifold` / `retract` — the blockwise projections of
                         `ops/manifolds.py` (d=2 closed-form polar with a
                         singular-block shift, d=3 QDWH, sphere rows
                         normalised; reference `CORA_problem.cpp:905-938`).

They run in float32 or float64 on any device, vectorised over poses with
reshapes and padded gathers. The range terms are summed per pose and per
landmark by a gather and a fixed-order `sum`, not `index_add_`, whose CUDA
atomics would make two solves from one point differ in the last bits.
The CPU runs them, the tests hold them against the JAX package, and on the
card they are what each kernel is compared with.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cora_tpu_torch.graph.data import ProblemData, torch_dtype
from cora_tpu_torch.ops.manifolds import (
    oblique_project,
    oblique_tangent_project,
    qdwh_l0,
    qdwh_weights,
    stiefel_hess_correction,
    stiefel_project,
    stiefel_tangent_project,
)
from cora_tpu_torch.utils.device import check_device

S_MAX = 8  # max range slots per pose the kernels support
L_MAX = 16  # max landmarks
# The kernels' rank-sized buffers live in dynamic shared memory sized at
# launch (`csrc/tnt_kernels.cu`: chain_smem, ladder_smem): RING partial-sum
# slots of max(l·r, 1) floats and the landmark solve's two (l, r) buffers;
# the ladder per trial point also 32 warp partials and 3 sums. What one
# block may use is the card's opt-in shared memory (232 448 bytes on
# sm_90, the only architecture the kernels are built for), less the
# kernels' static shared memory (< SMEM_STATIC).
RING = 4
SMEM_OPTIN = 232448
SMEM_STATIC = 1024
INT32_MAX = 2 ** 31 - 1


def chain_smem_bytes(l: int, r: int) -> int:
    """Dynamic shared memory of `step`, `tcg`, `chunk` and `ladder_block`
    at rank r with l landmarks."""
    return 4 * (RING * max(l * r, 1) + 2 * l * r)


def ladder_smem_bytes(l: int, r: int, ab: int) -> int:
    """Dynamic shared memory of a `ladder` cluster batching ab trial
    points at rank r."""
    return 4 * ab * (RING * max(l * r, 1) + 32 + 2 * l * r + 3)


def ladder_batch_max(l: int, r: int) -> int:
    """The most trial points one `ladder` cluster can batch at rank r."""
    return (SMEM_OPTIN - SMEM_STATIC) // ladder_smem_bytes(l, r, 1)


def rank_bound(l: int, N: int) -> int:
    """The largest rank the kernels take for l landmarks and N state rows:
    their buffers (a ladder cluster of one trial point, the largest) must
    fit in one block's shared memory, and N·r must index as int32.
    The JAX package's bound is its VMEM guard (`cora_tpu/ops/
    pallas_tcg.py` `kernel_supported`); this is the card's counterpart."""
    by_index = INT32_MAX // max(N, 1)
    if l == 0:
        return by_index
    # a trial point's (RING + 2)·l·r floats and its 32 + 3 of
    # `ladder_smem_bytes`
    floats = (SMEM_OPTIN - SMEM_STATIC) // 4 - 35
    return min(floats // ((RING + 2) * l), by_index)


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


def build_chain_plan(problem, dtype=np.float32, device="cuda",
                     max_cond: float = 1e6,
                     lam: float | None = None) -> ChainPlan:
    """All constants of the chain ops for one problem (host numpy/scipy,
    then one upload to `device`, the card unless the caller asks for
    another; raises without one). The banded factor uses the identity pose
    ordering and λ = ‖Q‖₂/(κ−1), as the JAX package's `build_tile_plan` does
    (reference `CORA_problem.cpp:590-591`). Coefficients come from the
    problem data in `dtype`, so a float32 plan carries float32-rounded
    measurements like the float32 solve."""
    from cora_tpu_torch.precond.banded import (
        doubling_propagators,
        estimate_spectral_norm,
        factor_banded,
    )

    dev = check_device(device)
    pd = problem.device_data(dtype=dtype, device="cpu")
    reason = plan_supported(pd)
    if reason is not None:
        raise NotImplementedError(f"chain plan unsupported: {reason}")

    d, n, l, m = pd.d, pd.n, pd.l, pd.m
    q, w = d + 1, 2 * (d + 1)
    nb = (n + 1) // 2
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
    levels, AF = doubling_propagators(F)
    C = np.zeros((nb * w, l))
    BinvC = np.zeros((nb * w, l))
    if l:
        C[:F.band_len] = F.C
        BinvC[:F.band_len] = F.BinvC
    capinv = F.cap_inv if l else np.zeros((0, 0))
    qd = [(c, b / c, a - b / c)
          for a, b, c in qdwh_weights(qdwh_l0(torch_dtype(dtype)), 8)]

    tdt = torch_dtype(dtype)

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


@dataclasses.dataclass
class ClusterPartition:
    """Which CTA of a `parts`-CTA group owns what (host numpy, int32).

    CTA c owns the band blocks [blk_ptr[c], blk_ptr[c+1]), the poses of
    those blocks (2·cb, 2·cb+1, below n), the ranges in those poses' slot
    rows, and the state rows of them all (rotation, bearing and translation
    rows); CTA 0 also owns the landmark rows. Every table lists a CTA's
    entries in ascending order, so one part (parts = 1) is the identity."""

    parts: int
    blk_ptr: np.ndarray  # (parts + 1,)
    row_ptr: np.ndarray  # (parts + 1,) rows own_rows[row_ptr[c]:row_ptr[c+1]]
    own_rows: np.ndarray  # (N,)
    rng_ptr: np.ndarray  # (parts + 1,) ranges own_rng[rng_ptr[c]:rng_ptr[c+1]]
    own_rng: np.ndarray  # (m,)
    lmc_ptr: np.ndarray  # (parts·l + 1,) CTA c's ranges of landmark k are
    lmc_rng: np.ndarray  # (m,)  lmc_rng[lmc_ptr[c·l+k]:lmc_ptr[c·l+k+1]]

    def poses(self, c: int, n: int) -> tuple[int, int]:
        """CTA c's poses [g0, g1)."""
        return (min(2 * int(self.blk_ptr[c]), n),
                min(2 * int(self.blk_ptr[c + 1]), n))

    def propagator_slice(self, c: int, k: int, nb: int,
                         adjoint: bool) -> tuple[int, int]:
        """The blocks [a, b) of propagator level k that CTA c reads: its own
        blocks in the forward pass, and in the adjoint pass (x_cb +=
        A_k[cb + 2ᵏ]ᵀ x_cb+2ᵏ for its own cb) the same range shifted by 2ᵏ,
        cut at nb. Block cb's propagator sits at cb − blk_ptr[c] either way."""
        b0, b1 = int(self.blk_ptr[c]), int(self.blk_ptr[c + 1])
        s = (1 << k) if adjoint else 0
        return min(b0 + s, nb), min(b1 + s, nb)


def cluster_partition(plan: ChainPlan, parts: int) -> ClusterPartition:
    """Split the band blocks into `parts` contiguous ranges of as equal a
    size as the count allows, and give each CTA the poses, ranges and rows
    that hang on its blocks (see `ClusterPartition`)."""
    if parts < 1:
        raise ValueError(f"parts={parts}")
    n, m, l, nb, d = plan.n, plan.m, plan.l, plan.nb, plan.d
    blk_ptr = (np.arange(parts + 1, dtype=np.int64) * nb) // parts
    rng_pose = plan.rng_pose.cpu().numpy().astype(np.int64)
    rng_lm = plan.rng_lm.cpu().numpy().astype(np.int64)
    # the CTA of pose g: the one whose block range holds g // 2
    owner = np.searchsorted(blk_ptr, np.arange(n) // 2, side="right") - 1
    rng_owner = owner[rng_pose]
    own_rng = np.argsort(rng_owner, kind="stable")
    rng_ptr = np.searchsorted(rng_owner[own_rng], np.arange(parts + 1))
    nd, tr0 = n * d, n * d + m
    rows, row_ptr = [], [0]
    for c in range(parts):
        g0, g1 = (min(2 * int(blk_ptr[c]), n), min(2 * int(blk_ptr[c + 1]), n))
        part = [np.arange(g0 * d, g1 * d),
                nd + own_rng[rng_ptr[c]:rng_ptr[c + 1]],
                np.arange(tr0 + g0, tr0 + g1)]
        if c == 0:
            part.append(np.arange(tr0 + n, tr0 + n + l))
        rows.append(np.concatenate(part))
        row_ptr.append(row_ptr[-1] + len(rows[-1]))
    lm_rng = plan.lm_rng.cpu().numpy().astype(np.int64)
    key = rng_owner[lm_rng] * max(l, 1) + rng_lm[lm_rng]
    lmc_rng = lm_rng[np.argsort(key, kind="stable")]
    lmc_ptr = np.searchsorted(np.sort(key), np.arange(parts * l + 1))
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return ClusterPartition(
        parts=parts, blk_ptr=i32(blk_ptr),
        row_ptr=i32(row_ptr), own_rows=i32(np.concatenate(rows)),
        rng_ptr=i32(rng_ptr), own_rng=i32(own_rng), lmc_ptr=i32(lmc_ptr),
        lmc_rng=i32(lmc_rng))


def ladder_groups(A: int, K: int) -> np.ndarray:
    """The α-batched `ladder`'s split of A trial points over K clusters:
    cluster k evaluates α[grp[k]:grp[k+1]], contiguous groups whose sizes
    differ by at most one. (K + 1,) int32."""
    if A < 1 or K < 1:
        raise ValueError(f"A={A}, K={K}")
    return ((np.arange(K + 1, dtype=np.int64) * A) // K).astype(np.int32)


@dataclasses.dataclass
class LadderLayout:
    """The α-batched `ladder`'s float32 scratch, in elements. Trial point
    a (global index) owns three (N, r) states at `state(a)`: the retracted
    Yn, then QY (whose rows hold P·grad once grad is formed), then grad.
    Cluster k owns two band buffers of (nb, w, cols(k)) at `band_off[k]`
    and `band_off[k] + band_len(k)`: one banded solve for its AB trial
    points' right-hand sides, trial point al's in columns al·r .. al·r + r,
    the column count rounded up to a multiple of 4 (float4 rows) and the
    buffers 16-byte aligned."""

    N: int
    r: int
    nbw: int  # nb · w
    grp: np.ndarray  # ladder_groups(A, K)

    @property
    def A(self) -> int:
        return int(self.grp[-1])

    @property
    def state_stride(self) -> int:
        return 3 * self.N * self.r

    def state(self, a: int) -> int:
        return a * self.state_stride

    def cols(self, k: int) -> int:
        return -(-int(self.grp[k + 1] - self.grp[k]) * self.r // 4) * 4

    def band_len(self, k: int) -> int:
        return self.nbw * self.cols(k)

    @property
    def band_off(self) -> np.ndarray:
        """(K + 1,) int64: cluster k's band buffers fill
        [band_off[k], band_off[k + 1])."""
        base = -(-self.A * self.state_stride // 4) * 4
        lens = [2 * self.band_len(k) for k in range(len(self.grp) - 1)]
        return base + np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    @property
    def total(self) -> int:
        return int(self.band_off[-1])


def ladder_layout(plan: ChainPlan, r: int, grp: np.ndarray) -> LadderLayout:
    return LadderLayout(N=plan.N, r=r, nbw=plan.nb * plan.w,
                        grp=np.asarray(grp, np.int32))


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
    return join(stiefel_tangent_project(Yr, Vr),
                oblique_tangent_project(Ys, Vs), Vt, Vl)


def hvp(plan: ChainPlan, Y: torch.Tensor, nablaF: torch.Tensor,
        dotY: torch.Tensor) -> torch.Tensor:
    """Proj_TY(Q Ẏ − Weingarten terms)."""
    H = qv(plan, dotY)
    Yr, Ys, _, _ = split(plan, Y)
    Gr, Gs, _, _ = split(plan, nablaF)
    dr, ds, _, _ = split(plan, dotY)
    Hr, Hs, Ht, Hl = split(plan, H)
    Hr = Hr - stiefel_hess_correction(Yr, Gr, dr)
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
    """Blockwise metric projection (`cora_tpu_torch.ops.manifolds`): the
    Stiefel polar factor per pose, sphere rows normalised, translations
    unchanged. `A` is (N, r) or a batch (..., N, r) of states."""
    Ar, As, At, Al = split(plan, A)
    return join(stiefel_project(Ar), oblique_project(As), At, Al)


def retract(plan: ChainPlan, Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Projection-based retraction (reference `CORA_problem.cpp:936-938`)."""
    return project_manifold(plan, Y + V)
