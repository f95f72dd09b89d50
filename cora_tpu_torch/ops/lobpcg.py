"""Blocked LOBPCG for the minimum eigenpairs of a symmetric linear operator,
as a device-resident loop.

Replaces the reference's vendored `Optimization::LinearAlgebra::LOBPCG`
(call sites `src/CORA_utils.cpp:90-176`), as the JAX package's
`cora_tpu/ops/lobpcg.py` does, with the same iteration: the operator acts
on the whole 3k-column search basis at once, the Rayleigh–Ritz step is a
3k×3k eigendecomposition, and a tall-skinny QR keeps the basis
orthonormal.

As the JAX package's `lax.while_loop`, the loop state (X, SX, P, θ, the
iteration count, the converged count, `done`) lives on the device, in
buffers allocated once per loop (`LobpcgLoop`), advanced by two step
functions that read nothing back: `setup` (the first orthonormalisation
and Rayleigh–Ritz) and `block` (`LOBPCG_BLOCK` masked iterations: once
`done` or at the cap every value keeps its old one, so the iteration count
and the result are those of JAX's exact loop). On a CUDA device both are
captured as CUDA graphs (`cora_tpu_torch.utils.graphs`) and replayed; the
host reads one small report per block (its stop flag, and with the last
block the loop's results). The Rayleigh–Ritz eigendecomposition is
`small_eigh` (a CUDA kernel on the card, since `torch.linalg.eigh`
synchronises), whose convergence flag comes with the results; the QR is
`torch.linalg.qr`, which captures. On the CPU, and inside
`device_loop(graphs=False)`, the same functions run eagerly, one iteration
per block; every way ends on the same bits.

The early-stop threshold is the reference's stop function: stop as soon
as the leading Ritz value drops below it (`CORA_utils.cpp:90-99`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cora_tpu_torch.ops.small_eigh import small_eigh
from cora_tpu_torch.utils import graphs as loops

# LOBPCG iterations per captured block (chosen on the card at 1/2/4/8,
# PERF.md §6); eager loops read after every iteration
LOBPCG_BLOCK = 4

# what the loops did, summed until `reset_loop_stats()`: captures and their
# seconds, replays, eager step calls, host reads (one report per block, none
# for a block that covers a cap nobody reads), blocks, LOBPCG iterations and
# solves
LOOP_STATS = dict(captures=0, capture_s=0.0, replays=0, eager_calls=0,
                  host_reads=0, blocks=0, iterations=0, solves=0)


def reset_loop_stats():
    loops.reset_stats(LOOP_STATS)


def _rayleigh_ritz(operator, Z):
    """(θ ascending, C, S·Z, eigensolver info) of the projection of the
    operator onto the orthonormal columns of Z."""
    SZ = operator(Z)
    A = Z.T @ SZ
    theta, C, info = small_eigh(0.5 * (A + A.T))
    return theta, C, SZ, info


class LobpcgLoop:
    """One LOBPCG solve's carry in fixed buffers and its two step
    functions, eager or captured. `X0` is the start block's buffer (a
    caller may hand in another loop's `X`, as the certificate's stage 2
    starts from stage 1's block); `cap` and `early` (the early-stop
    threshold) are device scalars filled before each solve, so one capture
    serves every solve with the same operator and shapes.

    Each block ends by writing its report, a vector in the loop's dtype
    whose first entry is the stop flag: `report(carry, stop)` (of
    `report_size` entries) when given, else (stop, iterations, converged
    pairs, eigensolver flag). The host reads the report once per block, so
    the last read carries the loop's results; with `read_last=False` the
    block that covers the cap is not read (nobody needs its report)."""

    def __init__(self, operator: Callable, N: int, k: int, dtype, device,
                 tol: float, nev: int, precon: Optional[Callable],
                 early_stop: bool, block: int, graphs: bool,
                 sync_debug: bool = False, X0: torch.Tensor | None = None,
                 report: Optional[Callable] = None, report_size: int = 4,
                 read_last: bool = True):
        self.operator, self.precon = operator, precon
        self.tol, self.nev, self.k, self.block = tol, nev, k, block
        self.early_stop, self.read_last = early_stop, read_last
        self.make_report = report or self._counts
        self.last = None  # the last report read (a host tensor)

        def buf(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.X0 = buf(N, k) if X0 is None else X0
        i64 = torch.int64
        self.c = dict(X=buf(N, k), SX=buf(N, k), P=buf(N, k), theta=buf(k),
                      it=buf(dt=i64), n_conv=buf(dt=i64),
                      done=buf(dt=torch.bool), bad=buf(dt=torch.bool))
        self.report = buf(report_size)
        self.cap = buf(dt=i64)
        self.early = buf()
        self.loop = loops.StepGraphs(
            dict(setup=self._setup, block=self._block), LOOP_STATS, graphs,
            device, sync_debug, scope="lobpcg")

    # --- the step functions -------------------------------------------------

    def _setup(self, commit=True):
        X = torch.linalg.qr(self.X0).Q
        theta, C, SX, info = _rayleigh_ritz(self.operator, X)
        zero = torch.zeros_like(self.c["it"])
        new = dict(X=X @ C, SX=SX @ C, P=torch.zeros_like(X), theta=theta,
                   it=zero, n_conv=zero,
                   done=torch.zeros_like(self.c["done"]), bad=info < 0)
        if commit:
            loops.copy_into(self.c, new)

    def _iteration(self, c: dict) -> dict:
        """One masked iteration (the JAX body, `cora_tpu/ops/lobpcg.py:
        73-100`): the convergence count on the block before the update,
        then the Rayleigh–Ritz over [X, W, P]."""
        k, nev = self.k, self.nev
        X, SX, P, theta = c["X"], c["SX"], c["P"], c["theta"]
        R = SX - X * theta[None, :]
        resnorm = torch.linalg.vector_norm(R, dim=0)
        scale = torch.clamp(theta.abs(), min=1.0)
        n_conv = (resnorm[:nev] <= self.tol * scale[:nev]).sum()
        W = self.precon(R) if self.precon is not None else R
        Q = torch.linalg.qr(torch.cat([X, W, P], dim=1)).Q
        theta_all, C, SQ, info = _rayleigh_ritz(self.operator, Q)
        Cx = C[:, :k]
        # search-direction memory: the (W, P) part
        Cp = torch.cat([torch.zeros_like(Cx[:k]), Cx[k:]])
        theta_new = theta_all[:k]
        done = n_conv >= nev
        if self.early_stop:
            done = done | (theta_new[0] < self.early)
        active = ~c["done"] & (c["it"] < self.cap)
        new = dict(X=Q @ Cx, SX=SQ @ Cx, P=Q @ Cp, theta=theta_new,
                   it=c["it"] + 1, n_conv=n_conv, done=done)
        out = {key: torch.where(active, v, c[key]) for key, v in new.items()}
        out["bad"] = c["bad"] | (active & (info < 0))
        return out

    def _counts(self, c: dict, stop) -> torch.Tensor:
        dt = self.report.dtype
        return torch.stack([stop.to(dt), c["it"].to(dt), c["n_conv"].to(dt),
                            c["bad"].to(dt)])

    def _block(self, commit=True):
        c = self.c
        for _ in range(self.block):
            c = self._iteration(c)
        report = self.make_report(c, c["done"] | (c["it"] >= self.cap))
        if commit:
            loops.copy_into(self.c, c)
            self.report.copy_(report)

    # --- driving ------------------------------------------------------------

    def solve(self, max_iters: int, early_stop_below=None):
        """Run from the block in `X0`: set-up, then blocks, reading each
        block's report until it says stop or the blocks have covered the
        cap. Leaves the result in `c` and the last report read in `last`."""
        self.cap.fill_(int(max_iters))
        if self.early_stop:
            self.early.fill_(early_stop_below)
        self.loop.run("setup")
        LOOP_STATS["solves"] += 1
        self.last, ran = None, 0
        while True:
            self.loop.run("block")
            LOOP_STATS["blocks"] += 1
            ran += self.block
            if ran >= max_iters and not self.read_last:
                return
            self.last = self.loop.read(self.report, tensor=True)
            if ran >= max_iters or self.last[0]:
                return


def loop_block(graphs: bool) -> int:
    return loops.options().block_of("lobpcg_block", LOBPCG_BLOCK, graphs)


def lobpcg_min(
    operator: Callable,
    X0: torch.Tensor,
    max_iters: int,
    tol: float = 1e-6,
    nev: int = 1,
    precon: Optional[Callable] = None,
    early_stop_below: Optional[float] = None,
    *,
    loop: LobpcgLoop | None = None,
):
    """The `nev` algebraically smallest eigenpairs of `operator`.

    Args:
      operator: symmetric linear map V (N, c) → (N, c).
      X0: (N, k) initial block, k ≥ nev.
      max_iters: iteration cap.
      tol: relative residual tolerance for convergence of the nev pairs.
      precon: optional SPD preconditioner V ↦ TV.
      early_stop_below: stop once the leading Ritz value is below this.
      loop: a kept `LobpcgLoop` built with this operator, preconditioner,
        tolerance and shape, to run on (its captured graphs replayed).

    Returns (theta (k,), X (N, k), iterations, converged pairs). As in the
    JAX package, the convergence count is taken on the block before each
    update, so the loop ends one update after the test first passes. The
    loop runs captured on a CUDA device unless `device_loop(graphs=False)`
    is in force. Without `loop`, the counts and the eigensolver's flag come
    with the last block's read (a flag raises) and the counts are returned
    as ints; with `loop`, the results stay in its buffers, the counts as
    device scalars, and what the caller needs comes with its report
    (`loop.last`).
    """
    own = loop is None
    if own:
        N, k = X0.shape
        graphs = X0.device.type == "cuda" and loops.options().graphs
        loop = LobpcgLoop(operator, N, k, X0.dtype, X0.device, tol, nev,
                          precon, early_stop_below is not None,
                          min(loop_block(graphs), max(max_iters, 1)), graphs,
                          loops.options().sync_debug)
    if X0 is not loop.X0:
        loop.X0.copy_(X0)
    loop.solve(max_iters, early_stop_below)
    c = loop.c
    if not own:
        return c["theta"], c["X"], c["it"], c["n_conv"]
    it, n_conv, bad = (int(v) for v in loop.last[1:4])
    LOOP_STATS["iterations"] += it
    if bad:
        raise RuntimeError("small_eigh did not converge in the LOBPCG "
                           "Rayleigh–Ritz step")
    return c["theta"].clone(), c["X"].clone(), it, n_conv
