// small_eigh: the full eigendecomposition of small symmetric matrices
// (n ≤ 96), one CTA per matrix, for the Rayleigh–Ritz step of LOBPCG.
//
// Replaces `jnp.linalg.eigh` inside the JAX package's LOBPCG
// `lax.while_loop` (cora_tpu/ops/lobpcg.py:61; not a Pallas kernel). The
// port's loop runs as captured CUDA graphs, and `torch.linalg.eigh` checks
// its LAPACK `info` on the host, which synchronises and breaks a capture.
// This kernel launches on the caller's stream, never synchronises, and
// leaves its convergence report in a device int.
//
// Algorithm: parallel-order (round-robin) cyclic Jacobi. A sweep is n_p − 1
// rounds (n_p = n rounded up to even; the pad index never rotates); a
// round rotates the n_p/2 disjoint pairs of the circle method at once:
//   phase 1: each pair's rotation (c, s, t) from the current A (GVL
//            sym.schur2), into shared memory;
//   phase 2: A ← JᵀAJ and V ← VJ, one thread per 2×2 block of A (i ≤ j,
//            the mirrored block written by the same thread, so A stays
//            exactly symmetric) and one per (row, pair) of V;
// each phase ended by __syncthreads. Before each sweep the off-diagonal
// mass is reduced: the loop stops at off(A) ≤ ε‖A‖_F, or at `max_sweeps`.
// The arithmetic is float64 for float32 matrices too (ε of float64): the
// Rayleigh–Ritz matrices are graded (eigenvalues from ~1e-3 to ~1e5 on the
// dataset-shaped graphs), and float32 rotations leave the eigenvectors of
// the smallest eigenvalues, the ones LOBPCG keeps, off by ~ε‖A‖/gap; the
// card's float64 costs the latency-bound rounds little. Then the eigenvalues are ranked ascending (ties by
// index) and each eigenvector's sign is fixed so that its entry of largest
// magnitude (the first on ties) is positive.
//
// What bounds it: the rounds are dependent steps through shared memory,
// so its time is (sweeps × (n_p − 1)) rounds of two barrier phases; the
// FLOPs (≈ 12 n² per round) are far below the card's rate. Hence one CTA
// with A and V resident in shared memory (2·96²·8 B = 147 KB), no
// device-memory traffic inside the loop, and a thread count matched to
// the (n_p/2)² blocks plus n·n_p/2 (row, pair) tasks of a round.
//
// info[b]: the sweeps taken (≥ 0) when converged, −1 when the sweep cap
// was reached first. A matrix with a non-finite entry gives NaN
// eigenpairs and info 0, as the JAX eigh returns NaN.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 96;
constexpr int MAX_PAIRS = MAX_N / 2;

constexpr double EPS = 2.220446049250313e-16;  // of double

// the pair at slot i of round rd (circle method over np players: player
// np − 1 fixed, the others rotating), as p < q
__device__ __forceinline__ void pair_of(int rd, int i, int np, int& p, int& q) {
  const int m = np - 1;
  int a, b;
  if (i == 0) {
    a = rd;
    b = m;
  } else {
    a = (rd + i) % m;
    b = (rd - i + m) % m;
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

template <typename T>
__device__ T block_sum(T v, T* red, int nwarps) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  T out = red[32];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

template <typename T>
__global__ void small_eigh_kernel(const T* __restrict__ A_in, T* __restrict__ w_out,
                                  T* __restrict__ V_out, int* __restrict__ info,
                                  int n, int max_sweeps) {
  using R = double;  // the arithmetic, whatever the input type
  extern __shared__ unsigned char smem_raw[];
  const int np = n + (n & 1);
  const int h = np / 2;
  R* A = reinterpret_cast<R*>(smem_raw);  // np × np
  R* V = A + np * np;                       // np × np
  __shared__ R cs_c[MAX_PAIRS], cs_s[MAX_PAIRS], cs_t[MAX_PAIRS];
  __shared__ int pr_p[MAX_PAIRS], pr_q[MAX_PAIRS];
  __shared__ R red[33];
  __shared__ R diag[MAX_N];
  __shared__ int perm[MAX_N];

  const int b = blockIdx.x;
  const T* Ab = A_in + (size_t)b * n * n;
  const int tid = threadIdx.x, nt = blockDim.x, nwarps = nt >> 5;

  // load the lower triangle, mirrored (as torch.linalg.eigh's UPLO='L')
  R sq = R(0);
  for (int e = tid; e < np * np; e += nt) {
    const int i = e / np, j = e % np;
    R a = R(0);
    if (i < n && j < n) a = R(i >= j ? Ab[i * n + j] : Ab[j * n + i]);
    A[e] = a;
    V[e] = i == j ? R(1) : R(0);
    sq += a * a;
  }
  __syncthreads();
  const R norm2 = block_sum(sq, red, nwarps);
  if (!isfinite(norm2)) {
    const R nan = R(0) / R(0);
    for (int e = tid; e < n * n; e += nt) V_out[(size_t)b * n * n + e] = T(nan);
    for (int i = tid; i < n; i += nt) w_out[(size_t)b * n + i] = T(nan);
    if (tid == 0) info[b] = 0;
    return;
  }
  const R tol2 = EPS * EPS * norm2;
  int sweeps = 0;
  bool converged = false;
  for (;;) {
    R part = R(0);
    for (int e = tid; e < np * np; e += nt) {
      if (e / np != e % np) part += A[e] * A[e];
    }
    const R off2 = block_sum(part, red, nwarps);
    if (off2 <= tol2) {
      converged = true;
      break;
    }
    if (sweeps == max_sweeps) break;
    for (int rd = 0; rd < np - 1; ++rd) {
      // phase 1: the rotations of this round's pairs
      for (int i = tid; i < h; i += nt) {
        int p, q;
        pair_of(rd, i, np, p, q);
        const R app = A[p * np + p], aqq = A[q * np + q], apq = A[p * np + q];
        R c = R(1), s = R(0), t = R(0);
        if (apq != R(0)) {
          const R tau = (aqq - app) / (R(2) * apq);
          t = (tau >= R(0) ? R(1) : R(-1)) / (fabs(tau) + hypot(R(1), tau));
          c = R(1) / sqrt(R(1) + t * t);
          s = t * c;
        }
        cs_c[i] = c;
        cs_s[i] = s;
        cs_t[i] = t;
        pr_p[i] = p;
        pr_q[i] = q;
      }
      __syncthreads();
      // phase 2: A ← JᵀAJ by 2×2 blocks (i ≤ j), V ← VJ by (row, pair)
      const int nblk = h * h, ntask = nblk + n * h;
      for (int task = tid; task < ntask; task += nt) {
        if (task < nblk) {
          const int i = task / h, j = task % h;
          if (i > j) continue;
          const int pi = pr_p[i], qi = pr_q[i];
          if (i == j) {
            const R apq = A[pi * np + qi], t = cs_t[i];
            A[pi * np + pi] -= t * apq;
            A[qi * np + qi] += t * apq;
            A[pi * np + qi] = R(0);
            A[qi * np + pi] = R(0);
            continue;
          }
          const int pj = pr_p[j], qj = pr_q[j];
          const R ci = cs_c[i], si = cs_s[i], cj = cs_c[j], sj = cs_s[j];
          const R x00 = A[pi * np + pj], x01 = A[pi * np + qj];
          const R x10 = A[qi * np + pj], x11 = A[qi * np + qj];
          // rows: Jᵢᵀ X
          const R y00 = ci * x00 - si * x10, y01 = ci * x01 - si * x11;
          const R y10 = si * x00 + ci * x10, y11 = si * x01 + ci * x11;
          // columns: Y Jⱼ
          const R z00 = cj * y00 - sj * y01, z01 = sj * y00 + cj * y01;
          const R z10 = cj * y10 - sj * y11, z11 = sj * y10 + cj * y11;
          A[pi * np + pj] = z00;
          A[pi * np + qj] = z01;
          A[qi * np + pj] = z10;
          A[qi * np + qj] = z11;
          A[pj * np + pi] = z00;
          A[qj * np + pi] = z01;
          A[pj * np + qi] = z10;
          A[qj * np + qi] = z11;
        } else {
          const int e = task - nblk, k = e / h, i = e % h;
          const int p = pr_p[i], q = pr_q[i];
          const R c = cs_c[i], s = cs_s[i];
          const R vp = V[k * np + p], vq = V[k * np + q];
          V[k * np + p] = c * vp - s * vq;
          V[k * np + q] = s * vp + c * vq;
        }
      }
      __syncthreads();
    }
    ++sweeps;
  }

  // rank the eigenvalues ascending (ties by index)
  for (int i = tid; i < n; i += nt) diag[i] = A[i * np + i];
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const R di = diag[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const R dj = diag[j];
      rank += (dj < di) || (dj == di && j < i);
    }
    perm[rank] = i;
    w_out[(size_t)b * n + rank] = T(di);
  }
  __syncthreads();
  // one warp per output column: the sign from its largest-magnitude entry
  const int lane = tid & 31, warp = tid >> 5;
  for (int col = warp; col < n; col += nwarps) {
    const int src = perm[col];
    R best = R(-1);
    int at = n;
    for (int k = lane; k < n; k += 32) {
      const R a = fabs(V[k * np + src]);
      if (a > best) {
        best = a;
        at = k;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const R ob = __shfl_down_sync(0xffffffffu, best, o);
      const int oa = __shfl_down_sync(0xffffffffu, at, o);
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    at = __shfl_sync(0xffffffffu, at, 0);
    const R sign = V[at * np + src] < R(0) ? R(-1) : R(1);
    for (int k = lane; k < n; k += 32)
      V_out[(size_t)b * n * n + k * n + col] = T(sign * V[k * np + src]);
  }
  if (tid == 0) info[b] = converged ? sweeps : -1;
}

template <typename T>
int launch(const void* A, void* w, void* V, void* info, int batch, int n,
           int max_sweeps, void* stream) {
  if (n < 1 || n > MAX_N || batch < 1) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  const int np = n + (n & 1), h = np / 2;
  const size_t smem = 2 * (size_t)np * np * sizeof(double);
  if (!attr_set) {
    // the largest dynamic size any n needs; set once, outside any capture
    const int most = 2 * MAX_N * MAX_N * (int)sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(
        small_eigh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int threads = h * h + n * h;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 64) threads = 64;
  small_eigh_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cora_small_eigh_f32(const void* A, void* w, void* V, void* info, int batch,
                        int n, int max_sweeps, void* stream) {
  return launch<float>(A, w, V, info, batch, n, max_sweeps, stream);
}

int cora_small_eigh_f64(const void* A, void* w, void* V, void* info, int batch,
                        int n, int max_sweeps, void* stream) {
  return launch<double>(A, w, V, info, batch, n, max_sweeps, stream);
}

int cora_small_eigh_max_n() { return MAX_N; }

}  // extern "C"
