"""`small_eigh`: the eigendecomposition of small symmetric matrices for
LOBPCG's Rayleigh–Ritz step, as CUDA kernels and their plain twin.

The JAX package calls `jnp.linalg.eigh` on the 3k × 3k Rayleigh–Ritz
matrix inside its LOBPCG `lax.while_loop` (`cora_tpu/ops/lobpcg.py:61`).
The port's loop runs as captured CUDA graphs, and `torch.linalg.eigh`
cannot be captured: it checks its LAPACK `info` on the host. So on the
card a kernel of `csrc/small_eigh.cu` runs instead (parallel-order
Jacobi; the source says what bounds it), for any n in float32 and float64,
computing in float64 for both (a float32 matrix's eigenpairs come out
rounded from float64 ones: LOBPCG keeps the smallest pairs of graded
matrices, where float32 rotations would lose them). `route` picks the
kernel: n ≤ `WARP_MAX_N` = 32 (every matrix of the main path: 3k = 30 and
k = 10) goes to the one-warp kernel (`small_eigh`: a lane per row of A,
three warps updating the rows and one computing the next round's
rotations), 32 < n ≤ `MAX_N` = 96 to the one-CTA kernel
(`small_eigh_cta`: a thread per 2 × 2 block, A and V in shared memory),
which gives the same bits where both run and is the other's comparator,
and n > 96 (a certificate at rank ≥ 31: k = r + 2, n = 3k) to the global
kernel (`small_eigh_global`: the one-CTA kernel's arithmetic, written
once for both, with A and V in a global workspace that stays in L2), the
same bits as the one-CTA kernel where both run. A kernel launches on
the current stream, never synchronises, and leaves a convergence report
per matrix in a device int (`info`: sweeps taken, −1 at the sweep cap),
which the caller reads with its other results.

Both versions return the eigenvalues in ascending order and fix each
eigenvector's sign so that its entry of largest magnitude (the first on
ties) is positive. The plain twin (`torch.linalg.eigh` plus that rule)
runs for tensors on the CPU only; on a CUDA tensor a kernel launches or
raises. A matrix with a non-finite entry gives NaN eigenpairs, as the JAX
package's `eigh` does.

Build: nvcc for sm_90a into `.torch_ext_build/` at first use
(`tnt_kernels.compile_library`), a plain C interface loaded with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from cora_tpu_torch.utils import graphs as loops

# the one-CTA kernel's largest n (A and V in its shared memory)
MAX_N = 96
# the one-warp kernel's largest n
WARP_MAX_N = 32
# Jacobi sweeps before a kernel reports "not converged" (they take 7-9 at
# n ≤ 96 on the card, PERF.md §6)
MAX_SWEEPS = 30
SOURCE = "small_eigh.cu"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel; the wrapper adds one where it launches (inside a
# captured graph: each replay, `utils.graphs.COUNTERS`)
LAUNCHES = {"small_eigh": 0, "small_eigh_cta": 0, "small_eigh_global": 0}
# route → launch key
KEYS = {"warp": "small_eigh", "cta": "small_eigh_cta",
        "global": "small_eigh_global"}
loops.COUNTERS.append(LAUNCHES)
BUILD_INFO: dict = {}

_LIB = None


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def load_library():
    """Build (once per source hash) and load the kernels' library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    import time

    from cora_tpu_torch.ops.tnt_kernels import KernelBuildError, \
        compile_library

    t0 = time.time()
    so, log = compile_library("cora_small_eigh", (SOURCE,), SOURCE,
                              NVCC_FLAGS)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelBuildError(f"cannot load {so}: {e}") from e
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.cora_small_eigh_cta_f32, lib.cora_small_eigh_cta_f64,
               lib.cora_small_eigh_warp_f32, lib.cora_small_eigh_warp_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    for fn in (lib.cora_small_eigh_global_f32, lib.cora_small_eigh_global_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
        fn.restype = ci
    lib.cora_small_eigh_global_work.argtypes = [ci]
    lib.cora_small_eigh_global_work.restype = ctypes.c_longlong
    lib.cora_small_eigh_max_n.restype = ci
    lib.cora_small_eigh_warp_max_n.restype = ci
    if (lib.cora_small_eigh_max_n(), lib.cora_small_eigh_warp_max_n()) \
            != (MAX_N, WARP_MAX_N):
        raise KernelBuildError(f"{so} was built for another MAX_N")
    BUILD_INFO.update(path=str(so), seconds=time.time() - t0, log=log)
    _LIB = lib
    return lib


def route(n: int, dtype, kernel: str | None = None) -> str:
    """The kernel an n × n matrix of `dtype` runs on the card: "warp" for
    n ≤ `WARP_MAX_N`, "cta" for n ≤ `MAX_N`, else "global"; `kernel`
    forces one (the probe's and the smoke test's comparisons). Raises for
    a size or a dtype no kernel takes."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"small_eigh: dtype {dtype}")
    if kernel not in (None, "warp", "cta", "global"):
        raise ValueError(f"small_eigh: no kernel {kernel!r}")
    most = {"warp": WARP_MAX_N, "cta": MAX_N}.get(kernel)
    if n < 1 or (most is not None and n > most):
        raise ValueError(f"small_eigh {kernel} takes n × n matrices with "
                         f"1 ≤ n ≤ {most}, got n = {n}")
    return kernel or ("warp" if n <= WARP_MAX_N else
                      "cta" if n <= MAX_N else "global")


def small_eigh_plain(A: torch.Tensor):
    """(w, V, info) by `torch.linalg.eigh` (lower triangle) with the sort
    and sign rule of the kernel; `info` is 0."""
    finite = torch.isfinite(A).all(dim=(-2, -1), keepdim=True)
    w, V = torch.linalg.eigh(torch.where(finite, A, torch.zeros_like(A)))
    at = V.abs().argmax(dim=-2, keepdim=True)
    sign = torch.where(V.gather(-2, at) < 0, -1.0, 1.0).to(V.dtype)
    nan = torch.full_like(V, float("nan"))
    return (torch.where(finite[..., 0], w, nan[..., 0]),
            torch.where(finite, V * sign, nan),
            torch.zeros(A.shape[:-2], dtype=torch.int32, device=A.device))


def small_eigh(A: torch.Tensor, kernel: str | None = None):
    """The eigendecomposition of the symmetric (n, n) or (B, n, n) `A`
    (its lower triangle is read): (w ascending, V with the eigenvectors as
    columns, info per matrix). On the CPU the plain twin; on the card the
    kernel `route` picks (or `kernel`), which raises for another dtype or
    a failed launch."""
    if A.device.type == "cpu":
        return small_eigh_plain(A)
    from cora_tpu_torch.ops.tnt_kernels import KernelLaunchError

    n = A.shape[-1]
    if A.shape[-2] != n:
        raise ValueError(f"small_eigh takes square matrices, got "
                         f"{tuple(A.shape)}")
    which = route(n, A.dtype, kernel)
    lib = load_library()
    Ab = A.reshape(-1, n, n).contiguous()
    batch = Ab.shape[0]
    w = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    V = torch.empty_like(Ab)
    info = torch.empty(batch, dtype=torch.int32, device=A.device)
    fn = getattr(lib, f"cora_small_eigh_{which}_"
                 f"{'f32' if A.dtype == torch.float32 else 'f64'}")
    args = [Ab.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(),
            batch, n, MAX_SWEEPS]
    if which == "global":
        work = torch.empty(batch * lib.cora_small_eigh_global_work(n),
                           dtype=torch.float64, device=A.device)
        args.append(work.data_ptr())
    err = fn(*args, torch.cuda.current_stream(A.device).cuda_stream)
    key = KEYS[which]
    if err:
        raise KernelLaunchError(f"{key} launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    lead = A.shape[:-2]
    return w.reshape(*lead, n), V.reshape(A.shape), info.reshape(lead)
