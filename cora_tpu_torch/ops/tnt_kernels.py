"""The TNT kernels: CUDA for Hopper, and their plain PyTorch versions.

Every TPU kernel of the JAX package is a method of `PallasTNT`
(`cora_tpu/ops/pallas_tcg.py`); all four are ported here, as hand-written
CUDA C++ in `csrc/` (device functions in `chain_ops.cuh`, kernels in
`tnt_kernels.cu`), built for sm_90a at first use:

| kernel   | replaces (pallas_call)          | computes                                   |
|----------|---------------------------------|--------------------------------------------|
| `step`   | `pallas_tcg.py:363-398` (`:182`) | retraction, f, gradient, ‖g‖, √⟨g,Pg⟩       |
| `tcg`    | `pallas_tcg.py:401-441` (`:182`) | one Steihaug–Toint preconditioned tCG solve |
| `chunk`  | `pallas_tcg.py:443-753` (`:733`) | TNT outer iterations up to `stop_at`        |
| `ladder` | `pallas_tcg.py:755-804` (`:792`) | step's scalars at retract(Y, α·Ẏ), all α    |

The kernels work on the canonical (N, r) row-major float32 state, not on
the TPU's 128-lane pose-pair tiles. `CudaTNT` launches them; `PlainTNT`
runs the same loops in Python on the plain versions of the device
functions (`cora_tpu_torch.ops.chain`). Both classes have the methods
`step`, `tcg`, `chunk` and `ladder`, with identical signatures and
semantics. `kernels_for` picks one from the device of the solve: the plain
versions run only for tensors on the CPU (or when the caller asks for them
with `use_kernels="never"`); on a CUDA device the kernels launch or raise.

What bounds them on the card: a tCG iteration is a chain of dependent
passes over ≤ 56k-element vectors, each ended by a group barrier —
2·levels + 5 per iteration (`work_counts`), 27 × 0.76 µs = 20.5 µs on the
plaza2-shaped graph at r = 4 (`scripts/probe_cluster_sync.py`) — and the
latency of each pass's loads; not bytes (each call reads its ~5 MB of
inputs once; a tCG iteration streams ~22 MB through L2, ~20 µs over 16
SMs) and not FLOPs. So `chunk`, `tcg` and `step` run as one thread-block
cluster of `CLUSTER` CTAs on neighbouring SMs: each pass spread over
`CLUSTER` SMs' L2 paths, the barrier in hardware (cluster.sync), each CTA
owning a contiguous range of band blocks and the rows that hang on them
(`chain.cluster_partition`). Measured, a tCG iteration takes 95-132 µs
inside a solve. `ladder` is one step at each of A = 48 trial points: it
launches K clusters (`LADDER_CLUSTERS`, at most what the card holds at
once), each evaluating a contiguous group of trial points
(`chain.ladder_groups`) in one pass chain, its band a solve with AB·r
columns (`chain.LadderLayout`); where A/K trial points do not fit one
block's shared memory at the rank, the points go in more, smaller groups,
launched K clusters at a time. The kernels take every rank up to
`chain.rank_bound` (their rank-sized buffers are dynamic shared memory
sized at launch), as the JAX package's take every rank its VMEM guard
admits. `step_block`, `ladder_block` (one CTA per
α), `chunk_block` and `tcg_block` are the single-CTA comparators that
chip_smoke.py times against the cluster kernels; the solver never launches
them. Times on the card beside the plain versions' and the bounds are in
PERF.md.

Build: `nvcc -O3 -gencode=arch=compute_90a,code=sm_90a` (no fast math)
into `<repo>/.torch_ext_build/`, a shared library with a plain C interface
loaded with ctypes — seconds to build, where a source that includes
PyTorch's headers takes minutes. The cluster size is a constant of the
build (`-DCORA_CLUSTER`): the reduction order depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np
import torch

from cora_tpu_torch.ops import chain
from cora_tpu_torch.ops.chain import ChainPlan, ClusterPartition
from cora_tpu_torch.solve.tnt import (
    DELTA_TOL,
    GRAD_TOL,
    PRECON_GRAD_TOL,
    RAMP_EXIT,
    REL_DECREASE,
    RUNNING,
    STEPSIZE,
)

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
SOURCES = ("chain_ops.cuh", "tnt_kernels.cu")
# CTAs in a cluster of `chunk`, `tcg`, `step` and `ladder`
# (scripts/probe_cluster_sync.py and PERF.md say why 16)
CLUSTER = 16
# clusters of the α-batched `ladder` (chip_smoke.py's sweep, PERF.md)
LADDER_CLUSTERS = 7
# trial points one ladder cluster may batch (the saddle escape's A); at a
# high rank shared memory allows fewer (chain.ladder_batch_max)
LADDER_MAX_BATCH = 48
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DCORA_CLUSTER={CLUSTER}")

# launches per kernel; each CudaTNT wrapper adds one where it launches
LAUNCHES = {"step": 0, "tcg": 0, "chunk": 0, "ladder": 0, "step_block": 0,
            "ladder_block": 0, "chunk_block": 0, "tcg_block": 0}
# how the library was built (for reports): path, seconds, ptxas output
BUILD_INFO: dict = {}
STREAK = 3

_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class KernelBuildError(RuntimeError):
    """nvcc failed or the library did not load."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error, or cannot be scheduled."""


class _PlanArgs(ctypes.Structure):
    _fields_ = (
        [(k, ctypes.c_int) for k in
         ("d", "n", "m", "l", "N", "nb", "w", "S", "levels", "parts")]
        + [(k, ctypes.c_void_p) for k in
           ("kap", "R", "tau", "tvec", "slot", "rng_pose", "rng_lm", "lm_ptr",
            "lm_rng", "rr", "om", "spiv", "cval", "Linv", "AF", "Ct",
            "BinvCt", "capinv", "qdwh", "blk_ptr", "row_ptr", "own_rows",
            "rng_ptr", "own_rng", "lmc_ptr", "lmc_rng")]
    )


class _TNTArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_float) for k in
                ("eta1", "eta2", "alpha1", "alpha2", "delta0", "grad_tol",
                 "pgrad_tol", "rel_dec_tol", "step_tol", "delta_tol", "kappa",
                 "theta")]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def compile_library(stem: str, sources, main: str, flags=NVCC_FLAGS):
    """nvcc `CSRC/main` into `BUILD_DIR/<stem>_<hash>.so`, once per hash of
    `sources` and `flags`: (path, nvcc's output, kept beside the library
    when it was built already). A failed build raises."""
    digest = hashlib.sha256()
    for name in sources:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(flags).encode())
    so = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    saved = BUILD_DIR / (so.stem + ".log")
    log = saved.read_text() if saved.exists() else ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / main)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        saved.write_text(log)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    return so, log


def load_library():
    """Build (once per source hash) and load the kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    t0 = time.time()
    so, log = compile_library("cora_tnt", SOURCES, "tnt_kernels.cu")
    try:
        lib = bind(ctypes.CDLL(str(so)))
    except OSError as e:
        raise KernelBuildError(f"cannot load {so}: {e}") from e
    if lib.cora_cluster_size() != CLUSTER:
        raise KernelBuildError(f"{so} was built for another cluster")
    BUILD_INFO.update(path=str(so), seconds=time.time() - t0, log=log)
    _LIB = lib
    return lib


def bind(lib):
    """The argument and result types of the library's C entry points."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.cora_step, lib.cora_step_block):
        fn.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp]
    for fn in (lib.cora_tcg, lib.cora_tcg_block):
        fn.argtypes = [vp, ci, vp, vp, vp, cf, ci, cf, cf, vp, vp, vp, vp]
    for fn in (lib.cora_chunk, lib.cora_chunk_block):
        fn.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp]
    lib.cora_ladder.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, ci, ci, vp,
                                vp, vp]
    lib.cora_ladder_block.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, vp]
    lib.cora_cluster_capacity.argtypes = [vp, ci, vp]
    lib.cora_ladder_capacity.argtypes = [vp, ci, ci, vp]
    lib.cora_cluster_size.argtypes = []
    for fn in (lib.cora_step, lib.cora_step_block, lib.cora_tcg,
               lib.cora_tcg_block, lib.cora_chunk, lib.cora_chunk_block,
               lib.cora_ladder, lib.cora_ladder_block,
               lib.cora_cluster_capacity, lib.cora_ladder_capacity,
               lib.cora_cluster_size):
        fn.restype = ci
    return lib


def work_counts(plan: ChainPlan, r: int, tcg_iters: int, kernel: str = "chunk",
                outer_iters: int = 0, init: bool = False, alphas: int = 0,
                parts: int = 1, clusters: int = 1) -> dict:
    """What one call of `kernel` must do, from the plan's shapes and this
    call's iteration counts: `bytes` (each input read once, each output
    written once), `flops` (the products and sums of the algorithm) and
    `phases` (dependent passes, each ended by a group barrier that spans
    all the CTAs of a cluster: 2·levels + 3 per tCG iteration, + 2 with
    landmarks). `parts` is the partition's CTA count, whose tables the
    kernel also reads. `ladder`'s `clusters` each read the propagators
    and Linv once for their group of trial points, which run their passes
    side by side: its phases are one step's."""
    n, m, l, d, N = plan.n, plan.m, plan.l, plan.d, plan.N
    nb, w, S, L = plan.nb, plan.w, plan.S, plan.levels
    lm = 1 if l > 0 else 0
    f4 = 4
    plan_bytes = f4 * (
        n * (2 + d * d + d) + n * S + 2 * m + (l + 1) + m + 4 * m
        + nb * w * w * (1 + L) + 2 * l * nb * w + l * l + 24
        + 3 * (parts + 1) + N + m + parts * l + 1 + m)
    state = f4 * N * r
    # dependent group-barrier phases
    precon = 2 * L + lm
    qv = 1 + lm
    step = qv + 3 + precon
    per_tcg = qv + 1 + precon + 1
    tcg_fixed = precon + 2
    # FLOPs: doubling scan and its adjoint, Linv and Linvᵀ, Woodbury,
    # Q·Y, the Weingarten and projection terms, elementwise updates and dots
    f_precon = 2 * r * (2 * L * nb * w * w + 2 * nb * w * w
                        + 2 * l * nb * w + l * l) + 8 * m * r
    f_qv = r * (n * (4 * d * d + 8 * d + 4 + 4 * S) + 12 * m)
    f_proj = r * (n * 4 * d * d + 4 * m)
    f_hvp = f_qv + 3 * f_proj
    f_dot = 2 * N * r
    f_step = f_qv + 2 * f_proj + f_precon + 3 * f_dot + r * n * 8 * d * d
    f_tcg = f_hvp + f_precon + f_proj + 2 * f_dot + 6 * N * r
    if kernel == "chunk":
        outs = 3 * state + f4 * (5 * outer_iters + 9)
        nbytes = plan_bytes + 3 * state + f4 * 20 + outs
        phases = (2 + (step if init else 0) + tcg_iters * per_tcg
                  + outer_iters * (tcg_fixed + step + 1))
        flops = (f_step * (outer_iters + int(init)) + f_tcg * tcg_iters
                 + outer_iters * (f_precon + f_proj + 2 * f_dot + 3 * N * r))
    elif kernel == "tcg":
        nbytes = plan_bytes + 3 * state + state + f4 * 4
        phases = tcg_fixed + tcg_iters * per_tcg + 1
        flops = f_tcg * tcg_iters + f_precon + f_proj + 2 * f_dot
    elif kernel == "step":
        nbytes = plan_bytes + 2 * state + 3 * state + f4 * 3
        phases = step + 1
        flops = f_step
    elif kernel == "ladder":
        propagators = f4 * nb * w * w * (1 + L)
        # + the group table (int32) and the band offsets (int64)
        nbytes = (plan_bytes + (clusters - 1) * propagators + 2 * state
                  + f4 * 4 * alphas + 12 * (clusters + 1))
        phases = step + 1
        flops = f_step * alphas
    else:
        raise ValueError(f"kernel={kernel!r}")
    return dict(bytes=int(nbytes), flops=int(flops), phases=int(phases),
                phases_per_tcg=per_tcg)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check_state(x: torch.Tensor, N: int, r: int, name: str):
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name} must be a float32 CUDA tensor")
    if tuple(x.shape) != (N, r) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({N}, {r}) tensor")


class CudaTNT:
    """The CUDA kernels for one chain plan (float32, on a CUDA device).
    `chunk`, `tcg` and `step` launch one cluster of the library's cluster
    size, `ladder` up to `LADDER_CLUSTERS` of them at once; construction
    raises KernelLaunchError if the card cannot hold one. They take ranks
    1..`rank_bound` (`chain.rank_bound`)."""

    route = "cuda"

    def __init__(self, plan: ChainPlan, params):
        if plan.device.type != "cuda":
            raise ValueError("CudaTNT needs a plan on a CUDA device")
        if plan.dtype != torch.float32:
            raise ValueError("the CUDA kernels run in float32")
        if plan.l > chain.L_MAX:
            raise ValueError(f"{plan.l} landmarks > {chain.L_MAX}")
        self.plan = plan
        self.params = params
        self.lib = load_library()
        self.cluster = CLUSTER
        i32 = torch.int32
        keep = dict(
            kap=plan.kap, R=plan.R, tau=plan.tau, tvec=plan.tvec,
            slot=plan.slot.to(i32), rng_pose=plan.rng_pose.to(i32),
            rng_lm=plan.rng_lm.to(i32), lm_ptr=plan.lm_ptr.to(i32),
            lm_rng=plan.lm_rng.to(i32), rr=plan.rr, om=plan.om,
            spiv=plan.spiv_inv, cval=plan.cval, Linv=plan.Linv, AF=plan.AF,
            Ct=plan.C.reshape(plan.nb * plan.w, plan.l).t(),
            BinvCt=plan.BinvC.reshape(plan.nb * plan.w, plan.l).t(),
            capinv=plan.capinv, qdwh=plan.qdwh,
        )
        # the device buffers must outlive every launch that reads them
        self._keep = {k: v.contiguous() for k, v in keep.items()}
        self._tables = {}
        self.parts = {1: chain.cluster_partition(plan, 1),
                      self.cluster: chain.cluster_partition(plan, self.cluster)}
        self._args1 = self._plan_args(self.parts[1])
        self._argsC = self._plan_args(self.parts[self.cluster])
        self.rank_bound = chain.rank_bound(plan.l, plan.N)
        # clusters that fit at once, per (kernel, rank, batch); the card
        # holds one 1024-thread CTA per SM whatever the shared memory, so
        # these are the same at every rank the bound admits
        self._capacity = {}
        self._fits("cluster", 1)
        p = params
        self._tnt = _TNTArgs(
            eta1=p.eta1, eta2=p.eta2, alpha1=p.alpha1, alpha2=p.alpha2,
            delta0=p.delta0, grad_tol=p.gradient_tolerance,
            pgrad_tol=p.preconditioned_gradient_tolerance,
            rel_dec_tol=p.relative_decrease_tolerance,
            step_tol=p.stepsize_tolerance, delta_tol=p.delta_tolerance,
            kappa=p.kappa_fgr, theta=p.theta)

    def _plan_args(self, part: ClusterPartition) -> _PlanArgs:
        plan = self.plan
        tables = {k: torch.as_tensor(getattr(part, k)).to(plan.device)
                  for k in ("blk_ptr", "row_ptr", "own_rows", "rng_ptr",
                            "own_rng", "lmc_ptr", "lmc_rng")}
        self._tables[part.parts] = tables  # outlive the launches, as _keep
        args = _PlanArgs(d=plan.d, n=plan.n, m=plan.m, l=plan.l, N=plan.N,
                         nb=plan.nb, w=plan.w, S=plan.S, levels=plan.levels,
                         parts=part.parts)
        for k, v in (*self._keep.items(), *tables.items()):
            setattr(args, k, v.data_ptr() if v.numel() else None)
        return args

    def _work(self, r: int, states: int, copies: int = 1) -> torch.Tensor:
        P = self.plan
        per = states * P.N * r + 2 * P.nb * P.w * r
        return torch.empty(copies * per, dtype=torch.float32,
                           device=P.device)

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.plan.device).cuda_stream

    @staticmethod
    def _done(name: str, err: int):
        if err != 0:
            raise KernelLaunchError(f"{name} kernel launch failed: CUDA error "
                                    f"{err}")
        LAUNCHES[name] += 1

    def _fits(self, kernel: str, r: int, ab: int = 0) -> int:
        """How many clusters of `kernel` ("cluster": chunk, tcg, step;
        "ladder" batching `ab` trial points) the card holds at once at rank
        r; raises KernelLaunchError if not one."""
        key = (kernel, r, ab)
        if key not in self._capacity:
            clusters = ctypes.c_int(0)
            args = ctypes.byref(self._argsC)
            err = (self.lib.cora_cluster_capacity(args, r,
                                                  ctypes.byref(clusters))
                   if kernel == "cluster" else
                   self.lib.cora_ladder_capacity(args, r, ab,
                                                 ctypes.byref(clusters)))
            if err != 0 or clusters.value < 1:
                raise KernelLaunchError(
                    f"no {kernel} cluster of {self.cluster} CTAs of 1024 "
                    f"threads can be scheduled at rank {r} (CUDA error "
                    f"{err}, {clusters.value} active clusters)")
            self._capacity[key] = clusters.value
        return self._capacity[key]

    def _rank(self, Y: torch.Tensor) -> int:
        r = int(Y.shape[1])
        if not 1 <= r <= self.rank_bound:
            raise ValueError(f"rank {r} outside 1..{self.rank_bound}, the "
                             f"ranks whose buffers fit the card's "
                             f"{chain.SMEM_OPTIN} bytes of shared memory")
        self._fits("cluster", r)
        return r

    def ladder_batch(self, r: int) -> int:
        """The most trial points one ladder cluster batches at rank r."""
        return min(LADDER_MAX_BATCH,
                   chain.ladder_batch_max(self.plan.l, r))

    def ladder_capacity(self, r: int) -> int:
        """Ladder clusters the card holds at once at rank r (at the
        largest batch, `ladder_batch(r)`)."""
        return self._fits("ladder", r, self.ladder_batch(r))

    def ladder_split(self, r: int, A: int, clusters: int | None = None):
        """(K, grp): the ladder's clusters per launch and its groups of
        trial points (`chain.ladder_groups`) at rank r. K is `clusters`
        (default `LADDER_CLUSTERS`, at most what the card holds), cut at
        A; the A points go in K groups, or in as many more as keep each
        group within `ladder_batch(r)`, run K at a time."""
        cap = self.ladder_capacity(r)
        if clusters is not None and not 1 <= clusters <= cap:
            raise ValueError(f"{clusters} ladder clusters; the card holds "
                             f"{cap} at rank {r}")
        K = min(clusters or min(LADDER_CLUSTERS, cap), A)
        groups = max(K, -(-A // self.ladder_batch(r)))
        return K, chain.ladder_groups(A, groups)

    def step(self, Y, s, do_retract: bool, block: bool = False):
        """(Y, s) → (Y_new, ∇F = QY_new, grad, [f, ‖grad‖, √⟨g,Pg⟩]);
        with do_retract False the state is evaluated as is. On the cluster,
        or with `block` on one CTA (the comparator)."""
        r = self._rank(Y)
        N = self.plan.N
        _check_state(Y, N, r, "Y")
        _check_state(s, N, r, "s")
        Yn, QY, grad = (torch.empty_like(Y) for _ in range(3))
        scal = torch.empty(3, dtype=torch.float32, device=Y.device)
        fn, args = ((self.lib.cora_step_block, self._args1) if block
                    else (self.lib.cora_step, self._argsC))
        err = fn(ctypes.byref(args), r, _ptr(Y), _ptr(s),
                 int(bool(do_retract)), _ptr(Yn), _ptr(QY), _ptr(grad),
                 _ptr(scal), _ptr(self._work(r, 1)), self._stream())
        self._done("step_block" if block else "step", err)
        return Yn, QY, grad, scal

    def tcg(self, grad, Y, nablaF, delta: float, max_iters: int,
            block: bool = False):
        """Full Steihaug–Toint solve → (s, [mdec, hit, iters, ‖s‖]), on the
        cluster, or with `block` on one CTA (the comparator)."""
        r = self._rank(Y)
        N = self.plan.N
        for x, nm in ((grad, "grad"), (Y, "Y"), (nablaF, "nablaF")):
            _check_state(x, N, r, nm)
        s = torch.empty_like(Y)
        scal = torch.empty(4, dtype=torch.float32, device=Y.device)
        fn, args = ((self.lib.cora_tcg_block, self._args1) if block
                    else (self.lib.cora_tcg, self._argsC))
        err = fn(ctypes.byref(args), r, _ptr(grad), _ptr(Y), _ptr(nablaF),
                 float(delta), int(max_iters), float(self.params.kappa_fgr),
                 float(self.params.theta), _ptr(s), _ptr(scal),
                 _ptr(self._work(r, 4)), self._stream())
        self._done("tcg_block" if block else "tcg", err)
        return s, scal

    def chunk(self, Y, grad, nablaF, fscal, iscal, hist, block: bool = False):
        """TNT outer iterations until `stop_at` or termination; Y, grad,
        nablaF, fscal (8,), iscal (12,) and hist (5, H) update in place. On
        the cluster, or with `block` on one CTA (the comparator)."""
        r = self._rank(Y)
        N = self.plan.N
        for x, nm in ((Y, "Y"), (grad, "grad"), (nablaF, "nablaF")):
            _check_state(x, N, r, nm)
        if fscal.dtype != torch.float32 or fscal.numel() != 8:
            raise ValueError("fscal must be 8 float32")
        if iscal.dtype != torch.int32 or iscal.numel() != 12:
            raise ValueError("iscal must be 12 int32")
        if hist.dtype != torch.float32 or hist.dim() != 2 or hist.shape[0] != 5:
            raise ValueError("hist must be (5, H) float32")
        for x in (fscal, iscal, hist):
            if x.device != Y.device or not x.is_contiguous():
                raise ValueError("scalars and histories must be contiguous "
                                 "on the state's device")
        fn, args = ((self.lib.cora_chunk_block, self._args1) if block
                    else (self.lib.cora_chunk, self._argsC))
        err = fn(ctypes.byref(args), ctypes.byref(self._tnt), r, _ptr(Y),
                 _ptr(grad), _ptr(nablaF), _ptr(fscal), _ptr(iscal),
                 _ptr(hist), int(hist.shape[1]), _ptr(self._work(r, 9)),
                 self._stream())
        self._done("chunk_block" if block else "chunk", err)
        return fscal, iscal

    def ladder(self, Y, Ydot, alphas, clusters: int | None = None,
               block: bool = False):
        """(3, A): f, ‖grad‖, √⟨g,Pg⟩ at retract(Y, α·Ẏ) for each α: the
        trial points batched over `clusters` clusters at a time
        (`ladder_split`: one launch per `clusters` groups), or with
        `block` one CTA per α (the comparator)."""
        r = self._rank(Y)
        N = self.plan.N
        _check_state(Y, N, r, "Y")
        _check_state(Ydot, N, r, "Ydot")
        alphas = alphas.to(Y.device, torch.float32).contiguous()
        A = int(alphas.numel())
        out = torch.empty((3, A), dtype=torch.float32, device=Y.device)
        if block:
            err = self.lib.cora_ladder_block(
                ctypes.byref(self._args1), r, _ptr(Y), _ptr(Ydot),
                _ptr(alphas), A, _ptr(out),
                _ptr(self._work(r, 4, copies=A)), self._stream())
            self._done("ladder_block", err)
            return out
        K, grp = self.ladder_split(r, A, clusters)
        ab = int(np.diff(grp).max())
        layout = chain.ladder_layout(self.plan, r, grp)
        grp_t = torch.as_tensor(grp).to(Y.device)
        off_t = torch.as_tensor(layout.band_off).to(Y.device)
        work = torch.empty(layout.total, dtype=torch.float32, device=Y.device)
        G = len(grp) - 1
        for g0 in range(0, G, K):  # one launch per K groups
            err = self.lib.cora_ladder(
                ctypes.byref(self._argsC), r, _ptr(Y), _ptr(Ydot),
                _ptr(alphas), A, _ptr(grp_t[g0:]), _ptr(off_t[g0:]),
                min(K, G - g0), ab, _ptr(out), _ptr(work), self._stream())
            self._done("ladder", err)
        return out


class PlainTNT:
    """The same four operations in Python on the plain chain ops (any
    device, float32 or float64) — the kernels' reference semantics."""

    route = "plain"

    def __init__(self, plan: ChainPlan, params):
        self.plan = plan
        self.params = params
        self.tiny = torch.finfo(plan.dtype).tiny

    def _scalar(self, x) -> torch.Tensor:
        return torch.tensor(x, dtype=self.plan.dtype, device=self.plan.device)

    def _step_core(self, Y, V, do_retract: bool):
        P = self.plan
        Yn = chain.retract(P, Y, V) if do_retract else Y
        QY = chain.qv(P, Yn)
        f = 0.5 * chain.dot(Yn, QY)
        grad = chain.tangent_project(P, Yn, QY)
        gn = torch.sqrt(chain.dot(grad, grad))
        pg = chain.tangent_project(P, Yn, chain.precon_solve(P, grad))
        ip = chain.dot(grad, pg)
        pgn = torch.where(ip > 0, torch.sqrt(torch.clamp(ip, min=0.0)), gn)
        return Yn, QY, grad, f, gn, pgn

    def _tcg_core(self, g, Y, nF, delta, miters: int):
        P = self.plan
        tiny = self.tiny
        kappa, theta = float(self.params.kappa_fgr), float(self.params.theta)

        def prec(v):
            return chain.tangent_project(P, Y, chain.precon_solve(P, v))

        z = prec(g)
        rz0 = chain.dot(g, z)
        sq = torch.sqrt(torch.clamp(rz0, min=0.0)) + tiny
        mk = torch.clamp(torch.exp(theta * torch.log(sq)), max=kappa)
        rz_stop = rz0 * (mk * mk)
        s = torch.zeros_like(g)
        rv = g.clone()
        dv = -z
        rz, dmd = rz0, rz0
        phi = sigma = mdec = self._scalar(0.0)
        k, hit = 0, False
        done = bool(rz0 <= 0)
        while k < miters and not done:
            Hd = chain.hvp(P, Y, nF, dv)
            dHd = chain.dot(dv, Hd)
            alpha = rz / torch.where(dHd == 0, tiny, dHd)
            phi_next = phi + 2.0 * alpha * sigma + alpha * alpha * dmd
            stop = bool((phi_next >= delta * delta) | (dHd <= 0))
            disc = torch.clamp(sigma * sigma + dmd * (delta * delta - phi),
                               min=0.0)
            tau = (-sigma + torch.sqrt(disc)) / torch.where(dmd == 0, tiny, dmd)
            if stop:
                s = s + tau * dv
                mdec = mdec + tau * rz - 0.5 * tau * tau * dHd
            else:
                s = s + alpha * dv
                mdec = mdec + 0.5 * alpha * rz
            rv = rv + alpha * Hd
            z = prec(rv)
            rz_new = chain.dot(rv, z)
            converged = bool(rz_new <= rz_stop)
            beta = rz_new / torch.where(rz == 0, tiny, rz)
            dv = -z + beta * dv
            sigma = beta * (sigma + alpha * dmd)
            dmd = rz_new + beta * beta * dmd
            rz = rz_new
            if not stop:
                phi = phi_next
            k += 1
            done = stop or converged
            hit = hit or stop
        return s, mdec, hit, k, torch.sqrt(chain.dot(s, s))

    def step(self, Y, s, do_retract: bool):
        Yn, QY, grad, f, gn, pgn = self._step_core(Y, s, bool(do_retract))
        if Yn is Y:
            Yn = Y.clone()
        return Yn, QY, grad, torch.stack([f, gn, pgn])

    def tcg(self, grad, Y, nablaF, delta: float, max_iters: int):
        s, mdec, hit, k, snorm = self._tcg_core(
            grad, Y, nablaF, self._scalar(delta), int(max_iters))
        return s, torch.stack([mdec, self._scalar(float(hit)),
                               self._scalar(float(k)), snorm])

    def chunk(self, Y, grad, nablaF, fscal, iscal, hist):
        p = self.params
        T = self._scalar
        tiny = self.tiny
        fs = [T(x) for x in fscal.tolist()]
        f, gn, pgn, Delta, lift_grad_norm, stall_tol = fs[:6]
        (k, status, finish, dec, stp, stop_at, tcg_cap, ramp_until, ramp_tcg,
         sw, init) = iscal.tolist()[:11]
        finish = finish > 0
        if init == 1:
            _, QY0, g0, f, gn, pgn = self._step_core(Y, None, False)
            grad.copy_(g0)
            nablaF.copy_(QY0)
            status = (GRAD_TOL if gn <= p.gradient_tolerance else
                      PRECON_GRAD_TOL
                      if pgn <= p.preconditioned_gradient_tolerance
                      else RUNNING)
        while k < stop_at and status == RUNNING:
            in_ramp = (not finish) and k < ramp_until
            s, mdec, hit, inner_k, step_norm = self._tcg_core(
                grad, Y, nablaF, Delta, ramp_tcg if in_ramp else tcg_cap)
            Yp, QYp, gradp, f_prop, gn_prop, pgn_prop = self._step_core(
                Y, s, True)
            rho = (f - f_prop) / torch.where(mdec == 0, tiny, mdec)
            accept = bool((rho >= p.eta1) & (mdec > 0))
            if accept:
                Y.copy_(Yp)
                grad.copy_(gradp)
                nablaF.copy_(QYp)
                f_new, gn, pgn = f_prop, gn_prop, pgn_prop
            else:
                f_new = f
            if not accept:
                Delta_new = p.alpha1 * Delta
            elif bool(rho >= p.eta2) and hit:
                Delta_new = p.alpha2 * Delta
            else:
                Delta_new = Delta
            rel_decrease = (f - f_prop) / (torch.abs(f) + tiny)
            small_decrease = accept and bool(
                rel_decrease < p.relative_decrease_tolerance)
            small_step = accept and bool(step_norm < p.stepsize_tolerance)
            dec = dec + 1 if small_decrease else (0 if accept else dec)
            stp = stp + 1 if small_step else (0 if accept else stp)
            if gn <= p.gradient_tolerance:
                status = GRAD_TOL
            elif pgn <= p.preconditioned_gradient_tolerance:
                status = PRECON_GRAD_TOL
            elif dec >= STREAK:
                status = REL_DECREASE
            elif stp >= STREAK:
                status = STEPSIZE
            elif Delta_new < p.delta_tolerance:
                status = DELTA_TOL
            else:
                status = RUNNING
            # histories first: the plateau test reads the lagged f
            hist[0, k] = f_new
            hist[1, k] = gn
            hist[2, k] = pgn
            hist[3, k] = step_norm if accept else 0.0
            hist[4, k] = inner_k
            f_lag = hist[0, max(k - sw, 0)].to(f_new.dtype)
            plateaued = sw > 0 and k >= sw and bool(
                (f_lag - f_new) < T(float(sw)) * stall_tol * torch.abs(f_new))
            boundary = (in_ramp and (k + 1 == ramp_until or plateaued)
                        and status == RUNNING)
            stall_now = status in (REL_DECREASE, STEPSIZE, DELTA_TOL)
            lift_now = boundary and bool(gn > lift_grad_norm)
            promote = ((in_ramp and stall_now)
                       or (boundary and bool(gn <= lift_grad_norm)))
            status = RAMP_EXIT if lift_now else (RUNNING if promote else status)
            finish = finish or promote
            if promote:
                Delta_new = T(p.delta0)
                dec = stp = 0
            f = f_new
            Delta = Delta_new
            k += 1
        fscal[:4] = torch.stack([f, gn, pgn, Delta]).to(fscal)
        iscal[:5] = torch.tensor([k, status, int(finish), dec, stp],
                                 dtype=iscal.dtype)
        return fscal, iscal

    def ladder(self, Y, Ydot, alphas):
        out = []
        for a in alphas.tolist():
            _, _, _, f, gn, pgn = self._step_core(
                Y, _scaled(a, Ydot), True)
            out.append(torch.stack([f, gn, pgn]))
        return torch.stack(out, dim=1)


def _scaled(a: float, V: torch.Tensor) -> torch.Tensor:
    """a·V with a rounded to V's dtype first, as the kernels compute it."""
    return torch.tensor(a, dtype=V.dtype, device=V.device) * V


def kernels_for(plan: ChainPlan, params, use_kernels: str = "auto"):
    """`CudaTNT` on a CUDA plan, `PlainTNT` on a CPU plan or when asked
    for with "never". "always" on the CPU raises: there is no emulation
    of the CUDA kernels."""
    if use_kernels not in ("auto", "always", "never"):
        raise ValueError(f"use_kernels={use_kernels!r}")
    if use_kernels == "never":
        return PlainTNT(plan, params)
    if plan.device.type == "cuda":
        return CudaTNT(plan, params)
    if use_kernels == "always":
        raise RuntimeError("use_kernels='always' needs a CUDA device; the "
                           "CUDA kernels have no CPU mode")
    return PlainTNT(plan, params)
