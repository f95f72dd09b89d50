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

What should bound the kernels on the card: one SM runs each solve
(single-CTA persistent kernels), so the limit is that SM's L2 bandwidth
for the preconditioner's doubling-scan propagators and the barrier count
per tCG iteration, not the card's FLOP rate (not yet measured with a
per-kernel trace). `ladder` runs its 48 trial points on 48 SMs. Times on
the card beside the plain versions' are in PERF.md.

Build: `nvcc -O3 -gencode=arch=compute_90a,code=sm_90a` (no fast math)
into `<repo>/.torch_ext_build/`, a shared library with a plain C interface
loaded with ctypes — seconds to build, where a source that includes
PyTorch's headers takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from cora_tpu_torch.ops import chain
from cora_tpu_torch.ops.chain import ChainPlan
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
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel; each CudaTNT wrapper adds one where it launches
LAUNCHES = {"step": 0, "tcg": 0, "chunk": 0, "ladder": 0}
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
    """A kernel launch returned a CUDA error."""


class _PlanArgs(ctypes.Structure):
    _fields_ = (
        [(k, ctypes.c_int) for k in
         ("d", "n", "m", "l", "N", "nb", "w", "S", "levels", "pad_")]
        + [(k, ctypes.c_void_p) for k in
           ("kap", "R", "tau", "tvec", "slot", "rng_pose", "rng_lm", "lm_ptr",
            "lm_rng", "rr", "om", "spiv", "cval", "Linv", "AF", "Ct",
            "BinvCt", "capinv", "qdwh")]
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


def load_library():
    """Build (once per source hash) and load the kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"cora_tnt_{digest.hexdigest()[:16]}.so"
    t0 = time.time()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / "tnt_kernels.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        (BUILD_DIR / (so.stem + ".log")).write_text(log)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelBuildError(f"cannot load {so}: {e}") from e
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cora_step.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.cora_tcg.argtypes = [vp, ci, vp, vp, vp, cf, ci, cf, cf, vp, vp, vp,
                             vp]
    lib.cora_chunk.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp]
    lib.cora_ladder.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, vp]
    for fn in (lib.cora_step, lib.cora_tcg, lib.cora_chunk, lib.cora_ladder):
        fn.restype = ci
    BUILD_INFO.update(path=str(so), seconds=time.time() - t0, log=log)
    _LIB = lib
    return lib


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check_state(x: torch.Tensor, N: int, r: int, name: str):
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name} must be a float32 CUDA tensor")
    if tuple(x.shape) != (N, r) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({N}, {r}) tensor")


class CudaTNT:
    """The CUDA kernels for one chain plan (float32, on a CUDA device)."""

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
        args = _PlanArgs(d=plan.d, n=plan.n, m=plan.m, l=plan.l, N=plan.N,
                         nb=plan.nb, w=plan.w, S=plan.S, levels=plan.levels,
                         pad_=0)
        for k, v in self._keep.items():
            setattr(args, k, v.data_ptr() if v.numel() else None)
        self._args = args
        p = params
        self._tnt = _TNTArgs(
            eta1=p.eta1, eta2=p.eta2, alpha1=p.alpha1, alpha2=p.alpha2,
            delta0=p.delta0, grad_tol=p.gradient_tolerance,
            pgrad_tol=p.preconditioned_gradient_tolerance,
            rel_dec_tol=p.relative_decrease_tolerance,
            step_tol=p.stepsize_tolerance, delta_tol=p.delta_tolerance,
            kappa=p.kappa_fgr, theta=p.theta)

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

    def _rank(self, Y: torch.Tensor) -> int:
        r = int(Y.shape[1])
        if not 1 <= r <= chain.R_MAX:
            raise ValueError(f"rank {r} outside 1..{chain.R_MAX}")
        return r

    def step(self, Y, s, do_retract: bool):
        """(Y, s) → (Y_new, ∇F = QY_new, grad, [f, ‖grad‖, √⟨g,Pg⟩]);
        with do_retract False the state is evaluated as is."""
        r = self._rank(Y)
        N = self.plan.N
        _check_state(Y, N, r, "Y")
        _check_state(s, N, r, "s")
        Yn, QY, grad = (torch.empty_like(Y) for _ in range(3))
        scal = torch.empty(3, dtype=torch.float32, device=Y.device)
        err = self.lib.cora_step(
            ctypes.byref(self._args), r, _ptr(Y), _ptr(s), int(bool(do_retract)),
            _ptr(Yn), _ptr(QY), _ptr(grad), _ptr(scal),
            _ptr(self._work(r, 1)), self._stream())
        self._done("step", err)
        return Yn, QY, grad, scal

    def tcg(self, grad, Y, nablaF, delta: float, max_iters: int):
        """Full Steihaug–Toint solve → (s, [mdec, hit, iters, ‖s‖])."""
        r = self._rank(Y)
        N = self.plan.N
        for x, nm in ((grad, "grad"), (Y, "Y"), (nablaF, "nablaF")):
            _check_state(x, N, r, nm)
        s = torch.empty_like(Y)
        scal = torch.empty(4, dtype=torch.float32, device=Y.device)
        err = self.lib.cora_tcg(
            ctypes.byref(self._args), r, _ptr(grad), _ptr(Y), _ptr(nablaF),
            float(delta), int(max_iters), float(self.params.kappa_fgr),
            float(self.params.theta), _ptr(s), _ptr(scal),
            _ptr(self._work(r, 4)), self._stream())
        self._done("tcg", err)
        return s, scal

    def chunk(self, Y, grad, nablaF, fscal, iscal, hist):
        """TNT outer iterations until `stop_at` or termination; Y, grad,
        nablaF, fscal (8,), iscal (12,) and hist (5, H) update in place."""
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
        err = self.lib.cora_chunk(
            ctypes.byref(self._args), ctypes.byref(self._tnt), r, _ptr(Y),
            _ptr(grad), _ptr(nablaF), _ptr(fscal), _ptr(iscal), _ptr(hist),
            int(hist.shape[1]), _ptr(self._work(r, 9)), self._stream())
        self._done("chunk", err)
        return fscal, iscal

    def ladder(self, Y, Ydot, alphas):
        """(3, A): f, ‖grad‖, √⟨g,Pg⟩ at retract(Y, α·Ẏ) for each α."""
        r = self._rank(Y)
        N = self.plan.N
        _check_state(Y, N, r, "Y")
        _check_state(Ydot, N, r, "Ydot")
        alphas = alphas.to(Y.device, torch.float32).contiguous()
        A = int(alphas.numel())
        out = torch.empty((3, A), dtype=torch.float32, device=Y.device)
        err = self.lib.cora_ladder(
            ctypes.byref(self._args), r, _ptr(Y), _ptr(Ydot), _ptr(alphas), A,
            _ptr(out), _ptr(self._work(r, 4, copies=A)), self._stream())
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
