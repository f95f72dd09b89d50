"""Problem formulations: translation-explicit and translation-implicit.

The implicit (marginalized) formulation (reference
`fillImplicitFormulationMatrices` / `dataMatrixProduct`,
`src/CORA_problem.cpp:714-757`; the JAX package's
`cora_tpu/models/formulations.py`) eliminates the translational states
analytically: with Q partitioned as

    [ Qmain  B  ]        Qmain: rotation+sphere block (dn+m)
    [ Bᵀ     L  ]        L: translation Laplacian (n+l), last state pinned

the reduced operator is  Q̃Y = Qmain·Y − B·L⁻¹·Bᵀ·Y  on states of height
dn+m, and translations are recovered as t = −L⁻¹·Bᵀ·Y
(`getTranslationExplicitSolution`, `CORA_problem.cpp:1168-1197`).

Qmain·Y + Bᵀ·Y and B·v both come from the explicit factored operator
applied to zero-padded states (no separate sparse matrices). L⁻¹ is a
direct solve: the reduced Laplacian is factored once on the host (banded
Cholesky under a reverse Cuthill–McKee ordering, landmarks as Woodbury
spikes), and the device applies it with the same doubling scan as the
banded preconditioner (`precond.banded._solve_band`: the forward scan L⁻¹
and its exact adjoint, host-formed float64 propagators cast to the solve's
dtype), the permutations taken by gathers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from cora_tpu_torch.graph.data import ProblemData, torch_dtype
from cora_tpu_torch.ops.quadratic import data_matrix_product
from cora_tpu_torch.precond import banded as bd
from cora_tpu_torch.types import Formulation

BW_CAP_LRED = 512  # pathological non-banded graphs are rejected


def _lred_factor(problem, pd: ProblemData) -> bd.BandedFactorHost:
    """Factor the reduced translation Laplacian L (last state pinned).

    Pose-translation nodes form the band under a reverse Cuthill–McKee
    ordering of their coupling graph (odometry chains + pose↔pose range
    edges; RCM interleaves multi-robot chains so inter-robot couplings
    land near the diagonal); landmark columns are Woodbury spikes. This is
    a direct solver (the implicit formulation needs exactness), so the
    band is factored with `require_exact` and graphs beyond `BW_CAP_LRED`
    are rejected."""
    import scipy.sparse.csgraph as csgraph

    n_tr = pd.num_translations
    off = pd.rot_range_size
    L = problem.data_matrix()[off:, off:].tocsr()[: n_tr - 1, : n_tr - 1]
    L = L.tocsr()

    n_band = min(pd.n, n_tr - 1)  # pose translations in the band
    l_sp = (n_tr - 1) - n_band  # remaining landmarks as spikes

    A = L[:n_band, :n_band]
    order = (
        np.asarray(csgraph.reverse_cuthill_mckee(A.tocsr(),
                                                 symmetric_mode=True),
                   dtype=np.int64)
        if n_band else np.zeros(0, dtype=np.int64)
    )
    B_band = A[order][:, order].tocsr()
    C = L[order, n_band:].toarray() if l_sp else np.zeros((n_band, 0))
    E = L[n_band:, n_band:].toarray() if l_sp else np.zeros((0, 0))

    coo = sp.tril(B_band).tocoo()
    bw = int((coo.row - coo.col).max()) if coo.nnz else 0
    if bw > BW_CAP_LRED:
        raise NotImplementedError(
            "translation Laplacian is not banded even under the RCM "
            f"ordering (bandwidth {bw} > {BW_CAP_LRED}); the implicit "
            "formulation requires banded+spikes structure")
    w = max(2 * (bw + 1), 2)
    Lc, Mc, Linv, BinvC, n_dropped, _cb = bd.banded_spd_factor(
        B_band, C, bw, w, require_exact=True)
    if l_sp:
        cap = E - C.T @ BinvC
        cap_chol = np.linalg.cholesky(0.5 * (cap + cap.T))
        cap_inv = np.linalg.inv(cap_chol.T) @ np.linalg.inv(cap_chol)
    else:
        cap_inv = np.zeros((0, 0))

    perm = np.concatenate([order, np.arange(n_band, n_tr - 1)])
    inv_perm = np.empty(n_tr - 1, dtype=np.int64)
    inv_perm[perm] = np.arange(n_tr - 1)
    return bd.BandedFactorHost(
        q=w, n_blocks=Lc.shape[0], band_len=n_band,
        perm=perm, inv_perm=inv_perm,
        L=Lc, M=Mc, Linv=Linv, s_sph=np.zeros(0),
        BinvC=BinvC, cap_inv=cap_inv, C=C, E=E,
        n_dropped=n_dropped, lam=0.0, bandwidth=bw,
    )


class LredSolve:
    """v ↦ L⁻¹v for the reduced translation Laplacian, on `device` in
    `dtype`: RCM gather → doubling-scan band solve → Woodbury landmark
    correction → inverse gather."""

    def __init__(self, F: bd.BandedFactorHost, dtype, device):
        levels, AF = bd.doubling_propagators(F)

        def T(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(device, dtype)

        self.fac = dict(Linv=T(F.Linv), AF=T(AF), levels=levels)
        self.n_blocks, self.q, self.band_len = F.n_blocks, F.q, F.band_len
        self.bandwidth = F.bandwidth
        self.spikes = F.C.shape[1]
        self.perm = torch.as_tensor(F.perm, device=device)
        self.inv_perm = torch.as_tensor(F.inv_perm, device=device)
        self.C, self.BinvC, self.cap_inv = T(F.C), T(F.BinvC), T(F.cap_inv)

    @property
    def propagator_bytes(self) -> int:
        """Device bytes of the scan's propagators (levels × blocks × q²)."""
        return self.fac["AF"].numel() * self.fac["AF"].element_size()

    def __call__(self, v: torch.Tensor) -> torch.Tensor:  # (n + l − 1, r)
        v = v[self.perm]  # RCM band order (landmark tail unchanged)
        nb, q, nq = self.n_blocks, self.q, self.band_len
        rhs_b, rhs_lm = v[:nq], v[nq:]
        if nb:
            r = v.shape[1]
            b = torch.cat([rhs_b, rhs_b.new_zeros((nb * q - nq, r))])
            y1 = bd._solve_band(self.fac, b.view(nb, q, r)).reshape(
                nb * q, r)[:nq]
        else:
            y1 = rhs_b
        if self.spikes:
            y2 = self.cap_inv @ (rhs_lm - self.C.T @ y1)
            x = torch.cat([y1 - self.BinvC @ y2, y2])
        else:
            x = torch.cat([y1, rhs_lm])
        return x[self.inv_perm]


class ImplicitOperators:
    """Marginalized quadratic-form operator and translation recovery.

    `full_product` overrides the full-height explicit product Q·Z: a
    sharded solve passes its sharded operator
    (`cora_tpu_torch.parallel.sharding`), so the marginalized products take
    one collective each, while the banded L⁻¹ apply stays replicated (a
    host-factored direct solve)."""

    def __init__(self, problem, pd: ProblemData, dtype=None,
                 full_product=None):
        self.pd = pd
        dt = pd.dtype() if dtype is None else torch_dtype(dtype)
        self.lred_solve = LredSolve(_lred_factor(problem, pd), dt, pd.device)
        if full_product is None:
            def full_product(Z):
                return data_matrix_product(pd, Z)
        self._full = full_product

    def _bt_y(self, Y):
        """[Qmain·Y ; Bᵀ·Y] via the explicit factored operator on [Y; 0]."""
        pd = self.pd
        full = self._full(torch.cat(
            [Y, Y.new_zeros((pd.num_translations, Y.shape[1]))]))
        return full[: pd.rot_range_size], full[pd.rot_range_size:]

    def _b_v(self, v_red):
        """B·v via the explicit operator on [0; v] (v lifted, pinned row 0)."""
        pd = self.pd
        r = v_red.shape[1]
        full = self._full(torch.cat(
            [v_red.new_zeros((pd.rot_range_size, r)), v_red,
             v_red.new_zeros((1, r))]))
        return full[: pd.rot_range_size]

    def product(self, Y):
        """Q̃·Y = Qmain·Y − B·L⁻¹·Bᵀ·Y (reference `dataMatrixProduct`)."""
        top, bt = self._bt_y(Y)
        return top - self._b_v(self.lred_solve(bt[:-1]))

    def translation_explicit_solution(self, Y):
        """The full explicit state [Y; t] with t = −L⁻¹BᵀY and the pinned
        translation at zero (reference `CORA_problem.cpp:1168-1197`)."""
        _, bt = self._bt_y(Y)
        t = -self.lred_solve(bt[:-1])
        return torch.cat([Y, t, Y.new_zeros((1, Y.shape[1]))])


def make_operator(problem, pd: ProblemData, formulation, dtype=None,
                  full_product=None) -> Callable:
    """The quadratic-form operator for the requested formulation, with
    `.implicit` its `ImplicitOperators` (None when explicit);
    `full_product` as in `ImplicitOperators`."""
    if formulation == Formulation.EXPLICIT:
        def op(Y):
            return data_matrix_product(pd, Y)

        op.implicit = None
        return op

    impl = ImplicitOperators(problem, pd, dtype, full_product=full_product)

    def op(Y):
        return impl.product(Y)

    op.implicit = impl
    return op
