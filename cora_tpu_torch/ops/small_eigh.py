"""`small_eigh`: the eigendecomposition of small symmetric matrices for
LOBPCG's Rayleigh–Ritz step, as a CUDA kernel and its plain twin.

The JAX package calls `jnp.linalg.eigh` on the 3k × 3k Rayleigh–Ritz
matrix inside its LOBPCG `lax.while_loop` (`cora_tpu/ops/lobpcg.py:61`).
The port's loop runs as captured CUDA graphs, and `torch.linalg.eigh`
cannot be captured: it checks its LAPACK `info` on the host. So on the
card the kernel of `csrc/small_eigh.cu` runs instead, one CTA per matrix
(parallel-order Jacobi with A and V in shared memory; the source says what
bounds it), for n ≤ `MAX_N` = 96 in float32 and float64, computing in
float64 for both (a float32 matrix's eigenpairs come out rounded from
float64 ones: LOBPCG keeps the smallest pairs of graded matrices, where
float32 rotations would lose them). It launches on
the current stream, never synchronises, and leaves a convergence report
per matrix in a device int (`info`: sweeps taken, −1 at the sweep cap),
which the caller reads with its other results.

Both versions return the eigenvalues in ascending order and fix each
eigenvector's sign so that its entry of largest magnitude (the first on
ties) is positive. The plain twin (`torch.linalg.eigh` plus that rule)
runs for tensors on the CPU only; on a CUDA tensor the kernel launches or
raises. A matrix with a non-finite entry gives NaN eigenpairs, as the JAX
package's `eigh` does.

Build: nvcc for sm_90a into `.torch_ext_build/` at first use
(`tnt_kernels.compile_library`), a plain C interface loaded with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from cora_tpu_torch.utils import graphs as loops

MAX_N = 96
# Jacobi sweeps before the kernel reports "not converged" (it takes 7-9 at
# n ≤ 96 on the card, PERF.md §6)
MAX_SWEEPS = 30
SOURCE = "small_eigh.cu"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of the kernel; the wrapper adds one where it launches (inside a
# captured graph: each replay, `utils.graphs.COUNTERS`)
LAUNCHES = {"small_eigh": 0}
loops.COUNTERS.append(LAUNCHES)
BUILD_INFO: dict = {}

_LIB = None


def reset_launch_counts() -> None:
    LAUNCHES["small_eigh"] = 0


def load_library():
    """Build (once per source hash) and load the kernel's library."""
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
    for fn in (lib.cora_small_eigh_f32, lib.cora_small_eigh_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    lib.cora_small_eigh_max_n.restype = ci
    if lib.cora_small_eigh_max_n() != MAX_N:
        raise KernelBuildError(f"{so} was built for another MAX_N")
    BUILD_INFO.update(path=str(so), seconds=time.time() - t0, log=log)
    _LIB = lib
    return lib


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


def small_eigh(A: torch.Tensor):
    """The eigendecomposition of the symmetric (n, n) or (B, n, n) `A`
    (its lower triangle is read): (w ascending, V with the eigenvectors as
    columns, info per matrix). On the CPU the plain twin; on the card the
    kernel, which raises for n > `MAX_N`, another dtype, or a failed
    launch."""
    if A.device.type == "cpu":
        return small_eigh_plain(A)
    from cora_tpu_torch.ops.tnt_kernels import KernelLaunchError

    n = A.shape[-1]
    if A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"small_eigh takes n × n matrices with n ≤ {MAX_N}, "
                         f"got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"small_eigh: dtype {A.dtype}")
    lib = load_library()
    Ab = A.reshape(-1, n, n).contiguous()
    batch = Ab.shape[0]
    w = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    V = torch.empty_like(Ab)
    info = torch.empty(batch, dtype=torch.int32, device=A.device)
    fn = lib.cora_small_eigh_f32 if A.dtype == torch.float32 \
        else lib.cora_small_eigh_f64
    err = fn(Ab.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(),
             batch, n, MAX_SWEEPS,
             torch.cuda.current_stream(A.device).cuda_stream)
    if err:
        raise KernelLaunchError(f"small_eigh launch failed: CUDA error {err}")
    LAUNCHES["small_eigh"] += 1
    lead = A.shape[:-2]
    return w.reshape(*lead, n), V.reshape(A.shape), info.reshape(lead)
