"""Problem data as torch tensors: the data matrix Q in factored edge-list form.

Q is never materialized on the device. It is stored as typed edge lists —

  * rotation connection Laplacian as an edge list of d×d blocks,
  * translational measurements as (from, to, t-vector, precision) rows,
  * range measurements as (from, to, distance, precision) rows —

from which the chain plan (`cora_tpu_torch.ops.chain`) derives the
per-pose coefficients that the kernels and their plain versions read.

Index layout matches the reference's canonical variable ordering
(`CORA_problem.cpp:964-1021`): state Y is (N, r) with rows
``[n·d rotation rows | m unit-bearing rows | n pose translations |
l landmark translations]``, N = n(d+1) + l + m.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cora_tpu_torch.graph.problem import ORIGIN_SYMBOL, Problem
from cora_tpu_torch.utils.device import check_device

META_FIELDS = ("d", "n", "l", "m", "num_pose_meas", "num_rot_edges",
               "chain_rot", "chain_pm")
INDEX_FIELDS = ("rot_i", "rot_j", "pm_ti", "pm_tj", "rng_ti", "rng_tj")
VALUE_FIELDS = ("rot_R", "rot_kappa", "pm_t", "pm_tau", "rng_r", "rng_omega")


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Factored data matrix + sizes. Index tensors are int64, values are
    of the solve's dtype, all on one device."""

    # --- sizes ---
    d: int  # spatial dimension (2 or 3)
    n: int  # number of poses
    l: int  # number of landmarks
    m: int  # number of range measurements
    num_pose_meas: int  # rows of T / At (rel-pose + priors + pose-landmark)
    num_rot_edges: int  # rel-pose + pose-prior edges
    chain_rot: bool  # rot edges are exactly (i, i+1) for i in 0..n-2
    chain_pm: bool  # pose-meas rows are exactly (i, i+1)

    # --- rotation connection Laplacian edges ---
    rot_i: torch.Tensor  # (E_rot,) rotation block index of first pose
    rot_j: torch.Tensor  # (E_rot,)
    rot_R: torch.Tensor  # (E_rot, d, d) measured relative rotations
    rot_kappa: torch.Tensor  # (E_rot,) rotation precisions

    # --- translational measurement rows (T / At / Omega_t) ---
    # ordering: [rel-pose | pose priors | pose-landmark | landmark priors]
    pm_ti: torch.Tensor  # (E,) "from" translational state (always a pose)
    pm_tj: torch.Tensor  # (E,) "to" translational state (0..n+l-1)
    pm_t: torch.Tensor  # (E, d) measured translations
    pm_tau: torch.Tensor  # (E,) translational precisions

    # --- range measurement rows ---
    rng_ti: torch.Tensor  # (m,) translational state indices
    rng_tj: torch.Tensor  # (m,)
    rng_r: torch.Tensor  # (m,) measured distances
    rng_omega: torch.Tensor  # (m,) range precisions

    @property
    def num_translations(self) -> int:
        return self.n + self.l

    @property
    def rot_size(self) -> int:
        return self.n * self.d

    @property
    def rot_range_size(self) -> int:
        return self.n * self.d + self.m

    @property
    def size(self) -> int:
        """Full (explicit-formulation) state height N."""
        return self.n * (self.d + 1) + self.l + self.m

    @property
    def device(self) -> torch.device:
        return self.rng_r.device

    def dtype(self) -> torch.dtype:
        return self.rng_r.dtype

    def to(self, device=None, dtype=None) -> "ProblemData":
        """A copy on `device` with its values in `dtype` (either kept when
        None); float32 values cast to float64 keep their float32 rounding."""
        dt = self.dtype() if dtype is None else torch_dtype(dtype)
        dev = self.device if device is None else torch.device(device)
        kw = {k: getattr(self, k).to(dev) for k in INDEX_FIELDS}
        kw.update({k: getattr(self, k).to(dev, dt) for k in VALUE_FIELDS})
        return dataclasses.replace(self, **kw)

    @functools.cached_property
    def incidence(self) -> "Incidence":
        """The fixed-order segment sums of the general-graph ops."""
        return Incidence.build(self)

    @classmethod
    def from_numpy(cls, fields: dict, device="cpu", dtype=np.float64):
        """Build from plain arrays keyed by field name — e.g. the JAX
        package's `ProblemData` fields passed through `np.asarray`."""
        tdtype = torch_dtype(dtype)
        kw = {k: bool(fields[k]) if k.startswith("chain") else int(fields[k])
              for k in META_FIELDS}
        for k in INDEX_FIELDS:
            kw[k] = torch.as_tensor(
                np.asarray(fields[k], np.int64), device=device)
        for k in VALUE_FIELDS:
            kw[k] = torch.as_tensor(
                np.asarray(fields[k], np.float64), device=device).to(tdtype)
        return cls(**kw)


class SegmentSum:
    """x (E, ...) ↦ out (num, ...), out[k] = Σ x[e] over e with idx[e] = k,
    in a fixed order: a gather through padded incidence tables and a `sum`
    over the padding axis, never `index_add_`, whose CUDA atomics make the
    result depend on the launch. Rows are bucketed by degree (powers of
    two), so a landmark with thousands of ranges does not pad every pose
    row to its degree. The tables are built once on the host."""

    def __init__(self, idx, num: int, device):
        idx = np.asarray(idx, np.int64)
        self.num = int(num)
        self.E = len(idx)
        order = np.argsort(idx, kind="stable")
        counts = np.bincount(idx, minlength=num)
        starts = np.concatenate([[0], np.cumsum(counts)])
        seg = idx[order]
        rank = np.arange(self.E) - starts[seg]  # place within its row
        width = np.where(counts > 0, 1 << np.ceil(np.log2(
            np.maximum(counts, 1))).astype(np.int64), 0)
        pos = np.zeros(self.num, np.int64)
        self.buckets = []
        for K in np.unique(width[width > 0]):
            rows = np.flatnonzero(width == K)
            pos[rows] = np.arange(len(rows))
            sel = width[seg] == K
            table = np.full((len(rows), K), self.E, np.int64)
            table[pos[seg[sel]], rank[sel]] = order[sel]
            self.buckets.append((torch.as_tensor(rows, device=device),
                                 torch.as_tensor(table, device=device)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        pad = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        out = x.new_zeros((self.num,) + x.shape[1:])
        for rows, table in self.buckets:
            out[rows] = pad[table].sum(1)
        return out


@dataclasses.dataclass
class Incidence:
    """Segment sums over the edge lists of one `ProblemData`:

      * `rot`: onto the n rotation blocks, of the values at
        [rot_i | rot_j | pm_ti];
      * `tr`: onto the n + l translations, of the values at
        [pm_tj | pm_ti | rng_tj | rng_ti];
      * `rng`: onto the n + l translations, of the values at
        [rng_ti | rng_tj]."""

    rot: SegmentSum
    tr: SegmentSum
    rng: SegmentSum

    @classmethod
    def build(cls, pd: "ProblemData") -> "Incidence":
        def host(*ts):
            return np.concatenate([t.cpu().numpy() for t in ts])

        dev = pd.device
        T = pd.num_translations
        return cls(
            rot=SegmentSum(host(pd.rot_i, pd.rot_j, pd.pm_ti), pd.n, dev),
            tr=SegmentSum(host(pd.pm_tj, pd.pm_ti, pd.rng_tj, pd.rng_ti), T,
                          dev),
            rng=SegmentSum(host(pd.rng_ti, pd.rng_tj), T, dev),
        )


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or type) → torch dtype; torch dtypes pass through."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def build_problem_data(problem: Problem, dtype=np.float64,
                       device="cuda") -> ProblemData:
    """Flatten a `Problem` into edge-list tensors (host → device, once; the
    card unless the caller asks for another device, raises without one)."""
    device = check_device(device)
    d = problem.dim
    n = problem.num_poses
    trans_offset = problem.rot_and_range_matrix_size

    # rotation edges: rel-pose measurements then pose priors (origin edges)
    rot_i, rot_j, rot_R, rot_kappa = [], [], [], []
    for meas in problem.rel_pose_measurements:
        rot_i.append(problem.rotation_idx(meas.first_id))
        rot_j.append(problem.rotation_idx(meas.second_id))
        rot_R.append(meas.R)
        rot_kappa.append(meas.rot_precision())
    for prior in problem.pose_priors:
        rot_i.append(problem.rotation_idx(ORIGIN_SYMBOL))
        rot_j.append(problem.rotation_idx(prior.id))
        rot_R.append(prior.R)
        rot_kappa.append(prior.rot_precision())

    # translational measurement rows (same ordering as assembly.build_submatrices)
    pm_ti, pm_tj, pm_t, pm_tau = [], [], [], []

    def add_pm(from_sym, to_sym, tvec, tau):
        pm_ti.append(problem.translation_idx(from_sym) - trans_offset)
        pm_tj.append(problem.translation_idx(to_sym) - trans_offset)
        pm_t.append(np.asarray(tvec, dtype=np.float64))
        pm_tau.append(tau)

    for meas in problem.rel_pose_measurements:
        add_pm(meas.first_id, meas.second_id, meas.t, meas.trans_precision())
    for prior in problem.pose_priors:
        add_pm(ORIGIN_SYMBOL, prior.id, prior.t, prior.trans_precision())
    for meas in problem.rel_pose_landmark_measurements:
        add_pm(meas.first_id, meas.second_id, meas.t, meas.trans_precision())
    for prior in problem.landmark_priors:
        add_pm(ORIGIN_SYMBOL, prior.id, prior.p, prior.trans_precision())

    rng_ti, rng_tj, rng_r, rng_omega = [], [], [], []
    for meas in problem.range_measurements:
        rng_ti.append(problem.translation_idx(meas.first_id) - trans_offset)
        rng_tj.append(problem.translation_idx(meas.second_id) - trans_offset)
        rng_r.append(meas.r)
        rng_omega.append(meas.precision())

    rot_i = np.asarray(rot_i, dtype=np.int64)
    rot_j = np.asarray(rot_j, dtype=np.int64)
    pm_ti_a = np.asarray(pm_ti, dtype=np.int64)
    pm_tj_a = np.asarray(pm_tj, dtype=np.int64)

    chain_rot = bool(
        len(rot_i) == max(n - 1, 0)
        and (rot_i == np.arange(max(n - 1, 0))).all()
        and (rot_j == np.arange(1, n)).all()
    ) if n > 1 else False
    chain_pm = bool(
        len(pm_ti_a) == max(n - 1, 0)
        and (pm_ti_a == np.arange(max(n - 1, 0))).all()
        and (pm_tj_a == np.arange(1, n)).all()
    ) if n > 1 else False

    def arr(x, shape, dt=np.float64):
        a = np.asarray(x, dtype=dt)
        return a.reshape(shape) if a.size else np.zeros(shape, dtype=dt)

    E = len(pm_ti)
    E_rot = len(rot_i)
    m = len(rng_ti)
    fields = dict(
        d=d, n=n, l=problem.num_landmarks, m=m,
        num_pose_meas=E, num_rot_edges=E_rot,
        chain_rot=chain_rot, chain_pm=chain_pm,
        rot_i=rot_i.reshape(E_rot), rot_j=rot_j.reshape(E_rot),
        rot_R=arr(rot_R, (E_rot, d, d)), rot_kappa=arr(rot_kappa, (E_rot,)),
        pm_ti=pm_ti_a.reshape(E), pm_tj=pm_tj_a.reshape(E),
        pm_t=arr(pm_t, (E, d)), pm_tau=arr(pm_tau, (E,)),
        rng_ti=arr(rng_ti, (m,), np.int64), rng_tj=arr(rng_tj, (m,), np.int64),
        rng_r=arr(rng_r, (m,)), rng_omega=arr(rng_omega, (m,)),
    )
    return ProblemData.from_numpy(fields, device=device, dtype=dtype)
