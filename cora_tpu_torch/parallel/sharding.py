"""Sharded Q·Y over a `torch.distributed` process group.

The counterpart of the JAX package's `cora_tpu/parallel/sharding.py`, with
its names. The design is that module's:

  * the state Y (N×r, tall and skinny) is **replicated** on every rank;
  * the measurement edge lists, where the work is, are **sharded** over
    the ranks of a 1-D mesh whose one axis is named `graph`;
  * each product takes one collective, and everything after it acts on the
    replicated output, so the whole trust-region solve runs on every rank
    alike.

Two operators:

  * edge-sharded (`make_sharded_operator`): rank k holds a contiguous slice
    of the zero-precision-padded edge arrays, forms the full-height (N, r)
    partial product of its slice, and one `all_reduce` sums them;
  * block-row (`make_blockrow_operator`, the default of
    `Problem.sharded_operator`): poses are split into K contiguous blocks,
    each edge goes to the owner of its first pose, and each rank forms only
    its block's rows plus a small separator buffer for the rows it touches
    elsewhere (cross-block edges, landmarks, inter-robot ranges). One
    `all_gather_into_tensor` brings every rank's rows; the separator sum
    (over the K slices in rank order) and the reassembly run on every rank.

The block-row product is split into `local(k, Y)`, the collective, and
`assemble(G)`, so the same arithmetic also runs with K shards emulated in
one process (`BlockRowOperator.emulated`): the bits equal those of a real
K-process group. Every sum is a fixed-order `SegmentSum`, never
`index_add_` or atomics, so every rank ends on the same bits and takes the
same branches (a rank that branched alone would leave the others waiting in
a collective).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cora_tpu_torch.graph.data import (
    INDEX_FIELDS,
    VALUE_FIELDS,
    ProblemData,
    SegmentSum,
)
from cora_tpu_torch.ops.quadratic import edge_terms, join_state, split_state

AXIS = "graph"


def make_mesh(device_type: str = "cuda", axis: str = AXIS):
    """1-D `DeviceMesh` named `axis` over every process of the default
    group, which must exist (`parallel.distributed.make_global_mesh` makes
    one when there is none)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: the CPU, or its current card."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pad_to(x: torch.Tensor, total: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((total - x.shape[0],) + x.shape[1:])])


def pad_problem_data(pd: ProblemData, num_shards: int) -> ProblemData:
    """Zero-pad edge arrays so each family divides evenly across shards.

    Padding edges point at index 0 with zero precision (κ=τ=ω=0), so they
    are mathematically inert. The sizes (`num_rot_edges`, …) stay those of
    the graph."""

    def up(k):
        return 0 if k == 0 else int(-(-k // num_shards) * num_shards)

    total = {"rot": up(pd.num_rot_edges), "pm": up(pd.num_pose_meas),
             "rng": up(pd.m)}
    kw = {f: _pad_to(getattr(pd, f), total[f.split("_")[0]])
          for f in INDEX_FIELDS + VALUE_FIELDS}
    return dataclasses.replace(pd, chain_rot=False, chain_pm=False, **kw)


def _edge_shard(pdp: ProblemData, K: int, k: int) -> ProblemData:
    """Shard k of K of padded problem data: a contiguous slice of each edge
    family, the sizes kept."""

    def part(t):
        n = t.shape[0] // K
        return t[k * n:(k + 1) * n]

    return dataclasses.replace(
        pdp, **{f: part(getattr(pdp, f)) for f in INDEX_FIELDS + VALUE_FIELDS})


def _rng_rows(pd_local: ProblemData, k: int) -> torch.Tensor:
    """The global bearing row of each of shard k's range edges (padding
    edges wrap around; they carry ω = 0)."""
    M = pd_local.rng_ti.shape[0]
    return (torch.arange(k * M, (k + 1) * M, device=pd_local.device)
            % max(pd_local.m, 1))


def shard_problem_data(pd: ProblemData, mesh) -> ProblemData:
    """This rank's contiguous slice of the padded edge arrays, on its
    device (the sizes stay the graph's)."""
    K = mesh.size()
    return _edge_shard(pad_problem_data(pd, K), K, mesh.get_local_rank())


def _partial_product(pd: ProblemData, rng_e: torch.Tensor,
                     Y: torch.Tensor) -> torch.Tensor:
    """Partial QY (full height) from a local edge shard. `rng_e` carries
    the *global* bearing row of each local range edge; a shard's rows are a
    contiguous run of at most m edges, mod m, so they are distinct and the
    bearing rows are a plain put."""
    Yrot, Ysph, Ytr = split_state(pd, Y)
    rot_terms, tr_terms, sph = edge_terms(pd, Yrot, Ytr, Ysph[rng_e])
    inc = pd.incidence
    out_rot = inc.rot(torch.cat(rot_terms)) if rot_terms else \
        torch.zeros_like(Yrot)
    out_tr = inc.tr(torch.cat(tr_terms)) if tr_terms else \
        torch.zeros_like(Ytr)
    out_sph = torch.zeros_like(Ysph)
    if sph is not None:
        out_sph = out_sph.index_put((rng_e,), sph)
    return join_state(pd, out_rot, out_sph, out_tr)


def make_sharded_operator(pd_sharded: ProblemData, mesh):
    """Q·Y with edges sharded over the mesh and one all_reduce per
    application. `pd_sharded` must come from `shard_problem_data`."""
    k = mesh.get_local_rank()
    rng_e = _rng_rows(pd_sharded, k)
    group = mesh.get_group()

    def op(Y):
        out = _partial_product(pd_sharded, rng_e, Y)
        dist.all_reduce(out, group=group)
        return out

    return op


# ---------------------------------------------------------------------------
# Block-row sharded operator
#
# The edge-sharded operator above is exact but every rank still touches all
# N output rows (full-height segment sums and a full (N, r) all_reduce), so
# the work per rank does not shrink with the mesh. The block-row design
# partitions POSES into contiguous blocks (SLAM trajectories are chains, so
# almost every edge is block-interior), assigns each edge to the owner of
# its first endpoint, and keeps all output accumulation LOCAL:
#
#   * per-rank segment sums over O(N/K) local rows;
#   * contributions to rows owned elsewhere (cross-block chain/loop edges,
#     landmark translations, inter-robot ranges) land in a small SEPARATOR
#     buffer, O(σ·r) with σ ≪ N;
#   * the replicated (N, r) output is reassembled from one all_gather of
#     the row blocks and the separators.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowBlockPlan:
    """Host-precomputed block-row partition (numpy).

    Arrays with leading dim K hold each rank's row. `sep_*` describe the
    shared separator row-units.
    """

    K: int
    B: int          # poses per block (last block zero-padded)
    m_loc: int      # max sphere rows owned by any rank
    n_sep_rot: int
    n_sep_tr: int
    # per-rank edge lists, (K, E_fam) each, zero-precision padded
    rot_i: np.ndarray; rot_j: np.ndarray; rot_R: np.ndarray; rot_kappa: np.ndarray
    rot_ti_loc: np.ndarray; rot_tj_loc: np.ndarray  # local/sep rot targets
    pm_ti: np.ndarray; pm_tj: np.ndarray; pm_t: np.ndarray; pm_tau: np.ndarray
    pm_ci_loc: np.ndarray; pm_ti_loc: np.ndarray; pm_tj_loc: np.ndarray
    rng_ti: np.ndarray; rng_tj: np.ndarray; rng_r: np.ndarray; rng_omega: np.ndarray
    rng_s_glob: np.ndarray  # global sphere row of each local range edge
    rng_s_loc: np.ndarray; rng_ti_loc: np.ndarray; rng_tj_loc: np.ndarray
    # global reassembly indices (replicated)
    sep_rot_ids: np.ndarray  # (σr,) global pose ids of the rot separators
    sep_tr_ids: np.ndarray   # (σt_pose,) global pose-translation separator ids
    sep_tr_sel: np.ndarray   # (σt_pose,) their slots within sep_tr
    sph_unperm: np.ndarray   # (m,) flat index into (K·m_loc) gathered sphere rows
    lm_sel: np.ndarray       # (l,) separator-tr slots of the landmark rows


def build_rowblock_plan(pd: ProblemData, K: int) -> RowBlockPlan:
    d, n, l, m = pd.d, pd.n, pd.l, pd.m
    B = -(-n // K) if n else 1
    owner = lambda p: np.minimum(
        np.asarray(p, np.int64) // B, K - 1).astype(np.int32)

    rot_i = _np(pd.rot_i); rot_j = _np(pd.rot_j)
    pm_ti = _np(pd.pm_ti); pm_tj = _np(pd.pm_tj)
    rng_ti = _np(pd.rng_ti); rng_tj = _np(pd.rng_tj)

    def edge_owner(a, b):
        # primary endpoint: a pose when available (landmark rows have no
        # owner block)
        a = np.asarray(a); b = np.asarray(b)
        prim = np.where(a < n, a, np.where(b < n, b, 0))
        return owner(prim)

    own_rot = edge_owner(rot_i, rot_j)
    own_pm = edge_owner(pm_ti, pm_tj)
    own_rng = edge_owner(rng_ti, rng_tj)

    # ---- separator units: rows an edge touches outside its own block ----
    def remote_pose(units, owners):
        u = np.asarray(units)
        return u[(u < n) & (owner(u) != owners)]

    sep_rot = np.unique(np.concatenate([
        remote_pose(rot_i, own_rot), remote_pose(rot_j, own_rot),
        remote_pose(pm_ti, own_pm),  # rot row of the pm edge's pose
    ])) if (rot_i.size or pm_ti.size) else np.zeros(0, np.int64)
    tr_units = [np.asarray(u)[(np.asarray(u) >= n) | (owner(u) != o)]
                for u, o in ((pm_ti, own_pm), (pm_tj, own_pm),
                             (rng_ti, own_rng), (rng_tj, own_rng))]
    # every landmark row is a separator (touched from many blocks)
    sep_tr = np.unique(np.concatenate(tr_units + [np.arange(n, n + l)])) \
        if (l or any(t.size for t in tr_units)) else np.zeros(0, np.int64)
    sep_rot_pos = {int(p): i for i, p in enumerate(sep_rot)}
    sep_tr_pos = {int(t): i for i, t in enumerate(sep_tr)}
    n_sr, n_st = len(sep_rot), len(sep_tr)

    # sphere-row ownership follows the owning edge; local order = edge order
    sph_local_idx = np.zeros(m, np.int64)
    m_loc = 1
    for k in range(K):
        sel = np.nonzero(own_rng == k)[0]
        sph_local_idx[sel] = np.arange(len(sel))
        m_loc = max(m_loc, len(sel))
    sph_unperm = (own_rng.astype(np.int64) * m_loc + sph_local_idx
                  if m else np.zeros(0, np.int64))

    def local_or_sep(units, owners, pos, n_local_units, n_sep, is_tr):
        """Target index in [0, n_local+n_sep+1): local unit, separator
        slot (offset n_local), or the inert dump slot (last)."""
        u = np.asarray(units, np.int64)
        loc = u - owners.astype(np.int64) * B
        if is_tr:
            is_local = (u < n) & (owner(u) == owners)
        else:
            is_local = owner(u) == owners
        sep_idx = np.array([pos.get(int(x), -1) for x in u], np.int64)
        tgt = np.where(is_local, loc, n_local_units + sep_idx)
        return np.where((is_local) | (sep_idx >= 0), tgt,
                        n_local_units + n_sep)

    rot_ti_loc = local_or_sep(rot_i, own_rot, sep_rot_pos, B, n_sr, False)
    rot_tj_loc = local_or_sep(rot_j, own_rot, sep_rot_pos, B, n_sr, False)
    pm_ci_loc = local_or_sep(pm_ti, own_pm, sep_rot_pos, B, n_sr, False)
    pm_ti_loc = local_or_sep(pm_ti, own_pm, sep_tr_pos, B, n_st, True)
    pm_tj_loc = local_or_sep(pm_tj, own_pm, sep_tr_pos, B, n_st, True)
    rng_ti_loc = local_or_sep(rng_ti, own_rng, sep_tr_pos, B, n_st, True)
    rng_tj_loc = local_or_sep(rng_tj, own_rng, sep_tr_pos, B, n_st, True)

    def bucket(owners, arrays, fill=0.0):
        """(K, E_max) per-rank edge buckets, padded inert."""
        E_max = 1
        sels = []
        for k in range(K):
            sel = np.nonzero(owners == k)[0]
            sels.append(sel)
            E_max = max(E_max, len(sel))
        outs = []
        for a in arrays:
            a = np.asarray(a)
            out = np.full((K, E_max) + a.shape[1:],
                          fill, a.dtype if a.dtype != np.int64 else np.int64)
            for k, sel in enumerate(sels):
                out[k, : len(sel)] = a[sel]
            outs.append(out)
        return outs

    (b_rot_i, b_rot_j, b_rot_R, b_rot_k, b_rot_ti, b_rot_tj) = bucket(
        own_rot, [rot_i, rot_j, _np(pd.rot_R),
                  _np(pd.rot_kappa), rot_ti_loc, rot_tj_loc])
    (b_pm_ti, b_pm_tj, b_pm_t, b_pm_tau, b_pm_ci, b_pm_til, b_pm_tjl) = bucket(
        own_pm, [pm_ti, pm_tj, _np(pd.pm_t), _np(pd.pm_tau),
                 pm_ci_loc, pm_ti_loc, pm_tj_loc])
    (b_rng_ti, b_rng_tj, b_rng_r, b_rng_om, b_rng_sg, b_rng_s, b_rng_til,
     b_rng_tjl) = bucket(
        own_rng, [rng_ti, rng_tj, _np(pd.rng_r),
                  _np(pd.rng_omega), np.arange(m, dtype=np.int64),
                  sph_local_idx, rng_ti_loc, rng_tj_loc])
    # padded edges: zero precision makes them inert; point targets at dumps
    for k in range(K):
        cnt = int((own_rot == k).sum())
        b_rot_k[k, cnt:] = 0
        b_rot_ti[k, cnt:] = B + n_sr
        b_rot_tj[k, cnt:] = B + n_sr
        cnt = int((own_pm == k).sum())
        b_pm_tau[k, cnt:] = 0
        b_pm_ci[k, cnt:] = B + n_sr
        b_pm_til[k, cnt:] = B + n_st
        b_pm_tjl[k, cnt:] = B + n_st
        cnt = int((own_rng == k).sum())
        b_rng_om[k, cnt:] = 0
        b_rng_s[k, cnt:] = m_loc  # dump sphere slot
        b_rng_til[k, cnt:] = B + n_st
        b_rng_tjl[k, cnt:] = B + n_st

    sep_tr_sel = np.nonzero(sep_tr < n)[0] if n_st else np.zeros(0, np.int64)
    lm_sel = np.array([sep_tr_pos[n + i] for i in range(l)], np.int64)

    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return RowBlockPlan(
        K=K, B=B, m_loc=m_loc, n_sep_rot=n_sr, n_sep_tr=n_st,
        rot_i=i32(b_rot_i), rot_j=i32(b_rot_j),
        rot_R=np.ascontiguousarray(b_rot_R), rot_kappa=np.ascontiguousarray(b_rot_k),
        rot_ti_loc=i32(b_rot_ti), rot_tj_loc=i32(b_rot_tj),
        pm_ti=i32(b_pm_ti), pm_tj=i32(b_pm_tj),
        pm_t=np.ascontiguousarray(b_pm_t), pm_tau=np.ascontiguousarray(b_pm_tau),
        pm_ci_loc=i32(b_pm_ci), pm_ti_loc=i32(b_pm_til), pm_tj_loc=i32(b_pm_tjl),
        rng_ti=i32(b_rng_ti), rng_tj=i32(b_rng_tj),
        rng_r=np.ascontiguousarray(b_rng_r), rng_omega=np.ascontiguousarray(b_rng_om),
        rng_s_glob=i32(b_rng_sg),
        rng_s_loc=i32(b_rng_s), rng_ti_loc=i32(b_rng_til), rng_tj_loc=i32(b_rng_tjl),
        sep_rot_ids=i32(sep_rot), sep_tr_ids=i32(sep_tr[sep_tr_sel]
                                                 if n_st else sep_tr),
        sep_tr_sel=i32(sep_tr_sel),
        sph_unperm=i32(sph_unperm), lm_sel=i32(lm_sel),
    )


class _RowBlock:
    """Rank k's edges of a `RowBlockPlan` as tensors (an edge family with
    no edges in the graph is left empty, as the JAX package skips it), with
    the segment sums onto its rotation buffer [block | separators | dump],
    its translation buffer likewise and its bearing rows [own | dump]."""

    def __init__(self, pd: ProblemData, plan: RowBlockPlan, k: int):
        dev, dt = pd.device, pd.dtype()
        B, n_sr, n_st = plan.B, plan.n_sep_rot, plan.n_sep_tr
        fam = {"rot": pd.num_rot_edges, "pm": pd.num_pose_meas, "rng": pd.m}

        def own(name):
            a = getattr(plan, name)[k]
            return a[:a.shape[0] if fam[name.split("_")[0]] else 0]

        for f in INDEX_FIELDS + ("rng_s_glob",):
            setattr(self, f, torch.as_tensor(own(f), dtype=torch.int64,
                                             device=dev))
        for f in VALUE_FIELDS:
            setattr(self, f, torch.as_tensor(own(f), device=dev).to(dt))
        cat = np.concatenate
        self.rot = SegmentSum(cat([own("rot_ti_loc"), own("rot_tj_loc"),
                                   own("pm_ci_loc")]), B + n_sr + 1, dev)
        self.tr = SegmentSum(cat([own("pm_tj_loc"), own("pm_ti_loc"),
                                  own("rng_tj_loc"), own("rng_ti_loc")]),
                             B + n_st + 1, dev)
        self.sph = SegmentSum(own("rng_s_loc"), plan.m_loc + 1, dev)


class BlockRowOperator:
    """The block-row product in its three parts: `local(k, Y)`, rank k's
    (L, r) rows [block rotations | block translations | own bearing rows |
    rotation separators | translation separators]; the all_gather of the K
    ranks' rows into G (K, L, r); `assemble(G)`, the replicated (N, r)
    product. Holds the tables of the ranks in `shards` (all K when None),
    on `pd`'s device."""

    def __init__(self, pd: ProblemData, plan: RowBlockPlan, shards=None):
        self.pd, self.plan = pd, plan
        self.shards = {k: _RowBlock(pd, plan, k)
                       for k in (range(plan.K) if shards is None else shards)}

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=pd.device)

        self.sep_rot_ids, self.sep_tr_ids = idx(plan.sep_rot_ids), \
            idx(plan.sep_tr_ids)
        self.sep_tr_sel, self.sph_unperm = idx(plan.sep_tr_sel), \
            idx(plan.sph_unperm)
        self.lm_sel = idx(plan.lm_sel)

    def local(self, k: int, Y: torch.Tensor) -> torch.Tensor:
        sh, pd, plan = self.shards[k], self.pd, self.plan
        B, n_sr, n_st, d, r = plan.B, plan.n_sep_rot, plan.n_sep_tr, pd.d, \
            Y.shape[1]
        Yrot, Ysph, Ytr = split_state(pd, Y)
        rot_terms, tr_terms, sph = edge_terms(sh, Yrot, Ytr,
                                              Ysph[sh.rng_s_glob])
        rot_buf = sh.rot(torch.cat(rot_terms)) if rot_terms else \
            Y.new_zeros((B + n_sr + 1, d, r))
        tr_buf = sh.tr(torch.cat(tr_terms)) if tr_terms else \
            Y.new_zeros((B + n_st + 1, r))
        sph_buf = sh.sph(sph) if sph is not None else \
            Y.new_zeros((plan.m_loc + 1, r))
        return torch.cat([
            rot_buf[:B].reshape(B * d, r),
            tr_buf[:B],
            sph_buf[:plan.m_loc],
            rot_buf[B:B + n_sr].reshape(n_sr * d, r),
            tr_buf[B:B + n_st],
        ])

    def assemble(self, G: torch.Tensor) -> torch.Tensor:
        pd, plan = self.pd, self.plan
        K, B, m_loc, n_sr = plan.K, plan.B, plan.m_loc, plan.n_sep_rot
        n, d, r = pd.n, pd.d, G.shape[2]
        sep_off = B * d + B + m_loc
        sep = G[0, sep_off:]
        for k in range(1, K):  # rank order, the same bits on every rank
            sep = sep + G[k, sep_off:]
        sep_rot = sep[: n_sr * d].reshape(n_sr, d, r)
        sep_tr = sep[n_sr * d:]

        g_rot = G[:, : B * d].reshape(K * B, d, r)[:n]
        g_tr = G[:, B * d: B * d + B].reshape(K * B, r)[:n]
        # the separator ids are distinct: a plain put, no accumulation
        if n_sr:
            ids = self.sep_rot_ids
            g_rot = g_rot.index_put((ids,), g_rot[ids] + sep_rot)
        if len(self.sep_tr_ids):
            ids = self.sep_tr_ids
            g_tr = g_tr.index_put((ids,), g_tr[ids] + sep_tr[self.sep_tr_sel])
        g_sph = G[:, B * d + B: sep_off].reshape(K * m_loc, r)
        return join_state(pd, g_rot, g_sph[self.sph_unperm],
                          torch.cat([g_tr, sep_tr[self.lm_sel]]))

    def emulated(self, Y: torch.Tensor) -> torch.Tensor:
        """The K-rank product in one process: every rank's local rows,
        stacked as the all_gather would, then assembled."""
        return self.assemble(torch.stack(
            [self.local(k, Y) for k in range(self.plan.K)]))


def make_blockrow_operator(pd: ProblemData, mesh, plan=None):
    """Replicated-in / replicated-out Q·Y with block-row local work and one
    `all_gather_into_tensor` per application."""
    K, k = mesh.size(), mesh.get_local_rank()
    if plan is None:
        plan = build_rowblock_plan(pd, K)
    br = BlockRowOperator(pd, plan, shards=(k,))
    group = mesh.get_group()

    def op(Y):
        loc = br.local(k, Y)
        G = loc.new_empty((K * loc.shape[0], loc.shape[1]))
        dist.all_gather_into_tensor(G, loc, group=group)
        return br.assemble(G.view(K, *loc.shape))

    return op
