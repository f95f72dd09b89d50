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
matrices, where float32 rotations would lose them). `route` picks one of
five routes, all giving the same bits where they overlap:
  * "warp", n ≤ `WARP_MAX_N` = 32 (every matrix of the main path: 3k = 30
    and k = 10; key `small_eigh`): one warp per row, three warps updating
    the rows and one computing the next round's rotations;
  * "cluster", 32 < n ≤ `CLUSTER_MAX_N` = 448 (a certificate at rank 9 to
    147: k = r + 2, n = 3k; key `small_eigh_cluster`): A's rows by
    circle-method position over a thread-block cluster of
    `cluster_size(n)` = 1, 2, 4, 8 or 16 CTAs, a look-ahead warp per 32
    pairs, the rotations logged; then V from the log and the sort, three
    kernels per call;
  * "grid", 448 < n ≤ `GRID_MAX_N` = 1056 (rank 148 to 350; key
    `small_eigh_grid`): the same kernels, the rounds on `grid_size(n)` =
    113-132 co-resident CTAs of a cooperative launch (one per SM, at most
    the card's SMs, two to four pairs each), the rows that cross a CTA
    boundary and the round table through L2, a grid barrier a round. Its workspace (the rotation log,
    `MAX_SWEEPS` × (n_p − 1) × n_p/2 × 16 B: 50 MB at n = 456, 267 MB at
    1056) is allocated per call, so inside LOBPCG's captured graphs it
    lives in the graph's memory pool;
  * "stream", n > 1056 (rank ≥ 351; key `small_eigh_stream`), and any n ≥
    `STREAM_MIN_N` = 5 where forced: the rounds on `stream_size(n)` ≤ 132
    co-resident CTAs as the grid's, but with A by index in the workspace
    (8·n_p² B: 9 MB at n = 1062, 36 MB at 2112, inside the H100's 50 MB
    L2 to about n = 2500, past which the same kernel runs from HBM); each
    CTA rewrites the rows of its slots in place, read from L2, so a round
    moves no row between CTAs: one barrier a round. V from the same log
    (1.07 GB at n = 2112, in the graphs' pool too): the registers' kernel
    to n = 1088, past it V's rows in shared memory (the log staged in whole
    rounds, past n ≈ 9 680 in parts of rounds); then the sort. It takes n
    to `STREAM_MAX_N` = 19 370, where the sort's ranking fills a block's
    shared memory; the card's memory runs out first (the log is 240·n² B:
    80 GB at n ≈ 18 000);
  * "global" (key `small_eigh_global`) and "cta", n ≤ `MAX_N` = 96 (key
    `small_eigh_cta`), routed to by no size: the comparators. The one-CTA
    kernel (a thread per 2 × 2 block, A and V in shared memory) is the
    first design, whose bits the others give; the global kernel is its
    body with A and V in a global workspace, for any n.
A call launches on the current stream, never synchronises, and leaves a
convergence report per matrix in a device int (`info`: sweeps taken, −1
at the sweep cap), which the caller reads with its other results.

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
# the cluster family's n: its smallest (a look-ahead needs two pairs) and
# its largest (A twice in the shared memory of at most CLUSTER_MAX_C CTAs)
CLUSTER_MIN_N = 3
CLUSTER_MAX_N = 448
CLUSTER_MAX_C = 16
# the grid route's largest n and CTAs (the H100's SMs; the launch checks
# the card's count and that all of them are resident at once)
GRID_MAX_N = 1056
GRID_MAX_G = 132
# the stream route's smallest n (at two pairs two look-ahead lanes would
# update one block) and its largest (`stream_fits`)
STREAM_MIN_N = 5
STREAM_MAX_N = 19370
# the sm_90 opt-in shared memory of a block, less room for the cluster
# kernel's static shared memory (small_eigh.cu CLUSTER_SMEM), and all of it
# (VEC_SMEM: the vectors and sort kernels)
CLUSTER_SMEM = 232448 - 1024
VEC_SMEM = 232448
# the fewest entries of the log the stream route's vectors kernel stages
VS_MIN_CHUNK = 32
# the n at which `load_library` holds the stream route's sizes to the
# library's: each side of the routes' boundaries and the certificates' n
STREAM_CHECKED = (4, 5, 6, 35, 36, 99, 516, 1056, 1057, 1062, 1536, 2112,
                  2409 * 3 + 6, STREAM_MAX_N)
# Jacobi sweeps before a kernel reports "not converged" (they take 7-9 at
# n ≤ 96 on the card, PERF.md §6)
MAX_SWEEPS = 30
SOURCE = "small_eigh.cu"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel; the wrapper adds one where it launches (inside a
# captured graph: each replay, `utils.graphs.COUNTERS`)
LAUNCHES = {"small_eigh": 0, "small_eigh_cluster": 0, "small_eigh_grid": 0,
            "small_eigh_stream": 0, "small_eigh_cta": 0, "small_eigh_global": 0}
# route → launch key
KEYS = {"warp": "small_eigh", "cluster": "small_eigh_cluster",
        "grid": "small_eigh_grid", "stream": "small_eigh_stream",
        "cta": "small_eigh_cta", "global": "small_eigh_global"}
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
    for fn in (lib.cora_small_eigh_cluster_f32,
               lib.cora_small_eigh_cluster_f64, lib.cora_small_eigh_grid_f32,
               lib.cora_small_eigh_grid_f64, lib.cora_small_eigh_stream_f32,
               lib.cora_small_eigh_stream_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
        fn.restype = ci
    lib.cora_small_eigh_global_work.argtypes = [ci]
    lib.cora_small_eigh_global_work.restype = ctypes.c_longlong
    lib.cora_small_eigh_cluster_work.argtypes = [ci, ci]
    lib.cora_small_eigh_cluster_work.restype = ctypes.c_longlong
    lib.cora_small_eigh_grid_work.argtypes = [ci, ci, ci]
    lib.cora_small_eigh_grid_work.restype = ctypes.c_longlong
    lib.cora_small_eigh_stream_work.argtypes = [ci, ci, ci]
    lib.cora_small_eigh_stream_work.restype = ctypes.c_longlong
    lib.cora_small_eigh_cluster_size.argtypes = [ci]
    lib.cora_small_eigh_grid_size.argtypes = [ci]
    lib.cora_small_eigh_stream_size.argtypes = [ci]
    for fn in (lib.cora_small_eigh_max_n, lib.cora_small_eigh_warp_max_n,
               lib.cora_small_eigh_cluster_max_n,
               lib.cora_small_eigh_cluster_size,
               lib.cora_small_eigh_grid_max_n, lib.cora_small_eigh_grid_size,
               lib.cora_small_eigh_stream_size,
               lib.cora_small_eigh_stream_max_n):
        fn.restype = ci
    if (lib.cora_small_eigh_max_n(), lib.cora_small_eigh_warp_max_n(),
            lib.cora_small_eigh_cluster_max_n(),
            lib.cora_small_eigh_grid_max_n(),
            lib.cora_small_eigh_stream_max_n()) \
            != (MAX_N, WARP_MAX_N, CLUSTER_MAX_N, GRID_MAX_N, STREAM_MAX_N):
        raise KernelBuildError(f"{so} was built for another MAX_N")
    if any(lib.cora_small_eigh_cluster_size(n) != cluster_size(n)
           for n in range(1, CLUSTER_MAX_N + 2)):
        raise KernelBuildError(f"{so} sizes its clusters otherwise")
    if any(lib.cora_small_eigh_grid_size(n) != grid_size(n)
           for n in range(1, GRID_MAX_N + 2)):
        raise KernelBuildError(f"{so} sizes its grid otherwise")
    if any(lib.cora_small_eigh_stream_size(n) != stream_size(n)
           or lib.cora_small_eigh_stream_work(n, MAX_SWEEPS, b)
           != stream_work_doubles(n, MAX_SWEEPS, b)
           for n in STREAM_CHECKED for b in (1, 2)):
        raise KernelBuildError(f"{so} sizes its stream route otherwise")
    BUILD_INFO.update(path=str(so), seconds=time.time() - t0, log=log)
    _LIB = lib
    return lib


def cluster_smem_bytes(n: int, clusters: int) -> int:
    """The cluster kernel's dynamic shared memory per CTA at n on
    `clusters` CTAs (small_eigh.cu `cluster_smem_doubles`): A's rows twice
    (two sides × ⌈h/C⌉ slots × (np + 1) doubles), the round table (2 × 7h
    doubles, rounded up to even) and the rows' next positions (2·⌈h/C⌉ 32-bit addresses),
    h = np / 2."""
    np_ = n + n % 2
    h = np_ // 2
    slots = -(-h // clusters)
    return 8 * (4 * slots * (np_ + 1) + 2 * (7 * h + h % 2) + slots)


def parts_fit(n: int, parts: int) -> bool:
    """Whether `parts` CTAs hold an n × n matrix (small_eigh.cu
    `parts_fit`): the shared memory, and ⌈h/parts⌉ ≥ 2 pairs a CTA (a CTA
    between two others needs two; the last that holds any may hold one,
    the pair h − 1, and those past it none)."""
    if n < CLUSTER_MIN_N or parts < 1:
        return False
    h = (n + n % 2) // 2
    if parts > 1 and -(-h // parts) < 2:
        return False
    return cluster_smem_bytes(n, parts) <= CLUSTER_SMEM


def cluster_fits(n: int, clusters: int) -> bool:
    """Whether a cluster of `clusters` CTAs (at most `CLUSTER_MAX_C`)
    holds an n × n matrix."""
    return clusters <= CLUSTER_MAX_C and parts_fit(n, clusters)


def cluster_size(n: int) -> int:
    """The CTAs of the cluster kernel at n: the smallest of 1, 2, 4, 8, 16
    that holds it (0: none does, past `CLUSTER_MAX_N`)."""
    return next((c for c in (1, 2, 4, 8, 16) if cluster_fits(n, c)), 0)


def grid_fits(n: int, ctas: int) -> bool:
    """Whether the grid route's `ctas` CTAs (2 to `GRID_MAX_G`) hold an
    n × n matrix, n ≤ `GRID_MAX_N`."""
    return n <= GRID_MAX_N and 2 <= ctas <= GRID_MAX_G and parts_fit(n, ctas)


def grid_size(n: int) -> int:
    """The CTAs of the grid route at n (small_eigh.cu `grid_size`): the
    most that hold it with two or more pairs each, at most `GRID_MAX_G`
    (the smallest ⌈h/G⌉ ≥ 2 the card's CTAs allow; 0: none holds it). A
    round's update on a CTA is bound by the entries of its pairs' rows that
    pass through its shared memory; more CTAs cost the barrier little."""
    h = (n + n % 2) // 2
    for slots in range(2, h + 1):
        g = -(-h // slots)
        if g <= GRID_MAX_G:
            return g if grid_fits(n, g) else 0
    return 0


def grid_work_doubles(n: int, max_sweeps: int, batch: int) -> int:
    """Doubles of the grid route's workspace for `batch` matrices
    (small_eigh.cu `cora_small_eigh_grid_work`): per matrix the cluster
    family's (`cluster_work_doubles`), then the round table (two parities
    of 7h doubles, h rounded up to even), the mailbox (two buffers × G CTAs
    × two sides × n_p) and the barrier's count with the verdict, rounded up
    to even."""
    np_ = n + n % 2
    h = np_ // 2
    extra = 2 * (7 * h + h % 2) + 4 * grid_size(n) * np_ + 1
    return batch * cluster_work_doubles(n, max_sweeps) + extra + extra % 2


def stream_size(n: int) -> int:
    """The CTAs of the stream route at n (small_eigh.cu `stream_size`): the
    most with two or more pairs each, at most `GRID_MAX_G` (0 below
    `STREAM_MIN_N`). Every CTA holds a pair; the last may hold one. A
    round's update on a CTA streams its pairs' rows through L2, so more
    CTAs share it; the barrier costs little more."""
    if n < STREAM_MIN_N:
        return 0
    h = (n + n % 2) // 2
    return next((-(-h // slots) for slots in range(2, h + 1)
                 if -(-h // slots) <= GRID_MAX_G), 0)


def stream_smem_bytes(n: int, ctas: int) -> int:
    """The stream kernel's dynamic shared memory per CTA (small_eigh.cu
    `stream_smem_bytes`): a round's (c, s) and pair of every slot (16 B and
    4 B each, the ints rounded up to even), t and the three entries of the
    CTA's ⌈h/G⌉ slots and their two neighbours' (32 B each), and the
    look-ahead's two blocks per slot (8 B)."""
    h = (n + n % 2) // 2
    slots = -(-h // ctas)
    return 16 * h + 4 * (h + h % 2) + 32 * (slots + 2) + 8 * slots


def stream_fits(n: int) -> bool:
    """Whether the stream route takes n (small_eigh.cu `stream_fits`): its
    CTAs' round table (`stream_smem_bytes`), the vectors kernel's one row of
    V and two chunks of the log, and the sort kernel's diagonal and ranking
    (12·n B, which binds first) each fit a block's shared memory."""
    ctas = stream_size(n)
    np_ = n + n % 2
    return (ctas > 0 and stream_smem_bytes(n, ctas) <= CLUSTER_SMEM
            and 8 * np_ + 2 * VS_MIN_CHUNK * 16 <= VEC_SMEM
            and 12 * n <= VEC_SMEM)


def stream_work_doubles(n: int, max_sweeps: int, batch: int) -> int:
    """Doubles of the stream route's workspace for `batch` matrices
    (small_eigh.cu `cora_small_eigh_stream_work`): per matrix the cluster
    family's (`cluster_work_doubles`: the log, V, A by index, two ints),
    then the global round table (two parities of 7h doubles, h rounded up
    to even), the stop test's partial sums (two buffers of 64) and the
    barrier's count, rounded up to even."""
    h = (n + n % 2) // 2
    extra = 2 * (7 * h + h % 2) + 128 + 1
    return batch * cluster_work_doubles(n, max_sweeps) + extra + extra % 2


def cluster_work_doubles(n: int, max_sweeps: int) -> int:
    """Doubles of the cluster family's workspace per matrix
    (small_eigh.cu `cluster_work_doubles`): the rotation log ((c, s) per
    slot for max_sweeps·(n_p − 1) + 1 rounds), V and A (n_p × n_p each) and
    two ints, rounded up to even."""
    np_ = n + n % 2
    h = np_ // 2
    total = 2 * (max_sweeps * (np_ - 1) + 1) * h + 2 * np_ * np_ + 1
    return total + total % 2


def route(n: int, dtype, kernel: str | None = None) -> str:
    """The kernel an n × n matrix of `dtype` runs on the card: "warp" for
    n ≤ `WARP_MAX_N`, "cluster" for n ≤ `CLUSTER_MAX_N`, "grid" for n ≤
    `GRID_MAX_N`, else "stream" (to `STREAM_MAX_N`); `kernel` forces one
    (the comparisons of the probe and the smoke test; "cta" and "global"
    only so), checked against its sizes. Raises for a size or a dtype no
    kernel takes."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"small_eigh: dtype {dtype}")
    if kernel not in (None, "warp", "cluster", "grid", "stream", "cta",
                      "global"):
        raise ValueError(f"small_eigh: no kernel {kernel!r}")
    least, most = {"warp": (1, WARP_MAX_N), "cta": (1, MAX_N),
                   "cluster": (CLUSTER_MIN_N, CLUSTER_MAX_N),
                   "stream": (STREAM_MIN_N, STREAM_MAX_N)}.get(kernel,
                                                              (1, None))
    if kernel == "grid":
        if not grid_size(n):
            raise ValueError(f"small_eigh grid takes no n × n matrix with "
                             f"n = {n} (two pairs a CTA, n ≤ {GRID_MAX_N})")
        return kernel
    if kernel is None and n > STREAM_MAX_N:
        least, most, kernel = STREAM_MIN_N, STREAM_MAX_N, "stream"
    if n < least or (most is not None and n > most):
        raise ValueError(f"small_eigh {kernel} takes n × n matrices with "
                         f"{least} ≤ n ≤ {most}, got n = {n}")
    return kernel or ("warp" if n <= WARP_MAX_N else
                      "cluster" if n <= CLUSTER_MAX_N else
                      "grid" if n <= GRID_MAX_N else "stream")


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
    kernel `route` picks (or `kernel`; the cluster kernel on
    `cluster_size(n)` CTAs, the grid on `grid_size(n)`, the stream route on
    `stream_size(n)`), which raises for another dtype or a failed launch
    (the grid and the stream route also where the card cannot hold their
    CTAs at once)."""
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
    elif which == "cluster":
        work = torch.empty(
            batch * lib.cora_small_eigh_cluster_work(n, MAX_SWEEPS),
            dtype=torch.float64, device=A.device)
        args.append(work.data_ptr())
    elif which == "grid":
        work = torch.empty(lib.cora_small_eigh_grid_work(n, MAX_SWEEPS, batch),
                           dtype=torch.float64, device=A.device)
        args.append(work.data_ptr())
    elif which == "stream":
        work = torch.empty(
            lib.cora_small_eigh_stream_work(n, MAX_SWEEPS, batch),
            dtype=torch.float64, device=A.device)
        args.append(work.data_ptr())
    err = fn(*args, torch.cuda.current_stream(A.device).cuda_stream)
    key = KEYS[which]
    if err:
        raise KernelLaunchError(f"{key} launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    lead = A.shape[:-2]
    return w.reshape(*lead, n), V.reshape(A.shape), info.reshape(lead)
