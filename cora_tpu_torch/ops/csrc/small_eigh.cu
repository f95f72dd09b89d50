// small_eigh: the full eigendecomposition of small symmetric matrices
// for the Rayleigh–Ritz step of LOBPCG, by parallel-order (round-robin)
// cyclic Jacobi, in three kernels that give the same bits where they
// overlap.
//
// Replaces `jnp.linalg.eigh` inside the JAX package's LOBPCG
// `lax.while_loop` (cora_tpu/ops/lobpcg.py:61; not a Pallas kernel). The
// port's loop runs as captured CUDA graphs, and `torch.linalg.eigh` checks
// its LAPACK `info` on the host, which synchronises and breaks a capture.
// Both kernels launch on the caller's stream, never synchronise, and leave
// their convergence report in a device int.
//
// Algorithm: a sweep is n_p − 1 rounds (n_p = n rounded up to even; the pad
// index rotates with zeros); a round rotates the n_p/2 disjoint pairs of
// the circle method at once: each pair's rotation (c, s, t) from the
// current A (GVL sym.schur2), then A ← JᵀAJ and V ← VJ. Before each sweep
// the off-diagonal mass is reduced: the loop stops at off(A) ≤ ε‖A‖_F, or
// at `max_sweeps`. The arithmetic is float64 for float32 matrices too (ε
// of float64): the Rayleigh–Ritz matrices are graded (eigenvalues from
// ~1e-3 to ~1e5 on the dataset-shaped graphs), and float32 rotations leave
// the eigenvectors of the smallest eigenvalues, the ones LOBPCG keeps, off
// by ~ε‖A‖/gap. Then the eigenvalues are ranked ascending (ties by index)
// and each eigenvector's sign is fixed so that its entry of largest
// magnitude (the first on ties) is positive.
//
// What bounds it: the rounds are dependent steps through shared memory, so
// the time is sweeps × (n_p − 1) rounds, each a float64 divide / hypot /
// sqrt chain for the rotations and then the update; the FLOPs (≈ 12 n² a
// round) are far below the card's rate.
//
// small_eigh_cta_kernel (n ≤ 96): one CTA per matrix, a thread per 2 × 2
//   block (i ≤ j) of A (the mirrored block written by the same thread, so A
//   stays exactly symmetric) and one per (row, pair) of V, A and V in
//   shared memory, two __syncthreads phases a round. The first design; it
//   runs the matrices of 32 < n ≤ 96 and is the comparator of the other.
// small_eigh_global_kernel (any n, routed n > 96): the one-CTA kernel's
//   body (`jacobi_cta`, written once for both) with A, V and the round's
//   tables in a global workspace instead of shared memory, at the same
//   thread count, so the same bits where both run. 2·n²·8 B stays in L2
//   (~1 MB at n = 246); each round's loads go through L1/L2, ~10 µs a
//   round at n = 99 on the H100 (PERF.md).
// small_eigh_warp_kernel (n ≤ 32): a lane per row of A and of V, in W = 3
//   update warps (each taking every W-th column pair of a round) and one
//   rotation warp that runs a round ahead: 4 warps, one per SM
//   sub-partition. A is double-buffered, its rows
//   padded to LD = 33 doubles, so that a warp's access to one column hits
//   32 different banks. In round rd the update warps write each lane's own
//   row of the new A from its row and its partner's row of the old one,
//   and its row of V, with round rd's rotations; meanwhile the rotation
//   warp computes the three entries round rd leaves at each pair of round
//   rd + 1 (the same way) and then round rd + 1's rotations, the latency
//   chain (divide, hypot, divide, sqrt, divide) that the one-CTA kernel
//   waits for at every round. One __syncthreads ends the round. Lane u's
//   entry in the block of its slot i and a slot j is computed as the
//   one-CTA kernel's thread for that block computes it: for i < j the block
//   (i, j), rows with Jᵢ then columns with Jⱼ; for i > j the block (j, i),
//   rows with Jⱼ then columns with Jᵢ, transposed. Every entry thus sees
//   the same operations in the same order (`rotation`, `rotate_block`,
//   `rotate_diag`, `rotate_v`, the arithmetic both kernels call), and the
//   stop test's sums are replayed in the one-CTA kernel's order for its
//   thread count (`replay_sum`): the two kernels give the same bits.
//
// info[b]: the sweeps taken (≥ 0) when converged, −1 when the sweep cap
// was reached first. A matrix with a non-finite entry gives NaN
// eigenpairs and info 0, as the JAX eigh returns NaN.

#include <cuda_runtime.h>

namespace {

using R = double;  // the arithmetic, whatever the input type

constexpr int MAX_N = 96;
constexpr int MAX_PAIRS = MAX_N / 2;
constexpr int WARP_N = 32;  // the one-warp kernel's largest n
constexpr int LD = WARP_N + 1;  // its row stride, in doubles
constexpr unsigned FULL = 0xffffffffu;

constexpr double EPS = 2.220446049250313e-16;  // of double

// the one-warp kernel's update warps (each CTA has one more, its rotation
// warp) and the column pairs a lane loads at once; a build may set another
// count (scripts/probe_small_eigh.py compares them)
#ifndef SMALL_EIGH_UPDATE_WARPS
#define SMALL_EIGH_UPDATE_WARPS 3
#endif
constexpr int W = SMALL_EIGH_UPDATE_WARPS;
constexpr int JB = (16 + W - 1) / W < 6 ? (16 + W - 1) / W : 6;

#ifdef SMALL_EIGH_SPLIT
// the probe's build: matrix 0's clock64() cycles, summed as
// `small_eigh_warp_kernel` says
__device__ long long split_clk[8];
#endif

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

// the same pair without a division: rd + i and rd − i + m lie below 2m
__device__ __forceinline__ void pair_fast(int rd, int i, int np, int& p, int& q) {
  const int m = np - 1;
  int a = rd + i, b = i == 0 ? m : rd - i + m;
  if (a >= m) a -= m;
  if (i != 0 && b >= m) b -= m;
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// the slot of index u in round rd (the inverse of pair_fast)
__device__ __forceinline__ int slot_of(int rd, int u, int np) {
  const int m = np - 1;
  if (u == m || u == rd) return 0;
  const int i = u >= rd ? u - rd : u - rd + m;
  return i < np / 2 ? i : m - i;
}

// u's partner in round rd
__device__ __forceinline__ int partner(int rd, int u, int np) {
  const int m = np - 1;
  if (u == m) return rd;
  if (u == rd) return m;
  const int v = 2 * rd - u;
  return v < 0 ? v + m : (v >= m ? v - m : v);
}

// the one-CTA kernel's launch width for n
__host__ __device__ inline int cta_threads(int n) {
  const int h = (n + (n & 1)) / 2;
  int threads = h * h + n * h;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 64) threads = 64;
  return threads;
}

// ---------------------------------------------------------------------------
// the arithmetic both kernels call

// the rotation (c, s, t) that zeroes apq (GVL sym.schur2)
__device__ __forceinline__ void rotation(R app, R aqq, R apq, R& c, R& s, R& t) {
  c = R(1);
  s = R(0);
  t = R(0);
  if (apq != R(0)) {
    const R tau = (aqq - app) / (R(2) * apq);
    t = (tau >= R(0) ? R(1) : R(-1)) / (fabs(tau) + hypot(R(1), tau));
    c = R(1) / sqrt(R(1) + t * t);
    s = t * c;
  }
}

// a pair's own diagonal entries after its rotation
__device__ __forceinline__ void rotate_diag(R app, R aqq, R apq, R t, R& pp, R& qq) {
  pp = app - t * apq;
  qq = aqq + t * apq;
}

// a 2 × 2 block of A: rows with (cr, sr) first, then columns with (cc, sc)
__device__ __forceinline__ void rotate_block(R cr, R sr, R cc, R sc, R x00, R x01,
                                             R x10, R x11, R& z00, R& z01, R& z10,
                                             R& z11) {
  // rows: Jᵣᵀ X
  const R y00 = cr * x00 - sr * x10, y01 = cr * x01 - sr * x11;
  const R y10 = sr * x00 + cr * x10, y11 = sr * x01 + cr * x11;
  // columns: Y J꜀
  z00 = cc * y00 - sc * y01;
  z01 = sc * y00 + cc * y01;
  z10 = cc * y10 - sc * y11;
  z11 = sc * y10 + cc * y11;
}

// a row's two entries of V at a pair's columns
__device__ __forceinline__ void rotate_v(R c, R s, R vp, R vq, R& np_, R& nq_) {
  np_ = c * vp - s * vq;
  nq_ = s * vp + c * vq;
}

// rank the eigenvalues ascending (ties by index), then one warp per output
// column: the sign from its largest-magnitude entry (threads tid of nt)
template <typename T>
__device__ void write_sorted(const R* A, const R* V, int ld, int n, R* diag,
                             int* perm, T* w_out, T* V_out, int tid, int nt) {
  for (int i = tid; i < n; i += nt) diag[i] = A[i * ld + i];
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const R di = diag[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const R dj = diag[j];
      rank += (dj < di) || (dj == di && j < i);
    }
    perm[rank] = i;
    w_out[rank] = T(di);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int col = warp; col < n; col += nwarps) {
    const int src = perm[col];
    R best = R(-1);
    int at = n;
    for (int k = lane; k < n; k += 32) {
      const R a = fabs(V[k * ld + src]);
      if (a > best) {
        best = a;
        at = k;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const R ob = __shfl_down_sync(FULL, best, o);
      const int oa = __shfl_down_sync(FULL, at, o);
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    at = __shfl_sync(FULL, at, 0);
    const R sign = V[at * ld + src] < R(0) ? R(-1) : R(1);
    for (int k = lane; k < n; k += 32) V_out[k * n + col] = T(sign * V[k * ld + src]);
  }
}

// ---------------------------------------------------------------------------
// the one-CTA kernel

template <typename T>
__device__ T block_sum(T v, T* red, int nwarps) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  T out = red[32];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

// Where one matrix's Jacobi state lives: shared memory (the one-CTA
// kernel) or a global workspace (the global kernel). The arithmetic below
// reads and writes it the same way wherever it is.
struct JacobiBufs {
  R* A;                   // np × np
  R* V;                   // np × np
  R *cs_c, *cs_s, *cs_t;  // (h) this round's rotations
  int *pr_p, *pr_q;       // (h) this round's pairs
  R* diag;                // (n)
  int* perm;              // (n)
};

// The one-CTA Jacobi of one matrix (the block's), its state in B, a thread
// per 2 × 2 block (i ≤ j) of A and one per (row, pair) of V, two
// __syncthreads phases a round.
template <typename T>
__device__ void jacobi_cta(const T* __restrict__ Ab, T* __restrict__ w_b,
                           T* __restrict__ V_b, int* __restrict__ info_b, int n,
                           int max_sweeps, const JacobiBufs& B, R* red) {
  const int np = n + (n & 1);
  const int h = np / 2;
  R* A = B.A;
  R* V = B.V;
  R *cs_c = B.cs_c, *cs_s = B.cs_s, *cs_t = B.cs_t;
  int *pr_p = B.pr_p, *pr_q = B.pr_q;
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
    for (int e = tid; e < n * n; e += nt) V_b[e] = T(nan);
    for (int i = tid; i < n; i += nt) w_b[i] = T(nan);
    if (tid == 0) info_b[0] = 0;
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
        R c, s, t;
        rotation(A[p * np + p], A[q * np + q], A[p * np + q], c, s, t);
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
            R pp, qq;
            rotate_diag(A[pi * np + pi], A[qi * np + qi], A[pi * np + qi], cs_t[i], pp,
                        qq);
            A[pi * np + pi] = pp;
            A[qi * np + qi] = qq;
            A[pi * np + qi] = R(0);
            A[qi * np + pi] = R(0);
            continue;
          }
          const int pj = pr_p[j], qj = pr_q[j];
          R z00, z01, z10, z11;
          rotate_block(cs_c[i], cs_s[i], cs_c[j], cs_s[j], A[pi * np + pj],
                       A[pi * np + qj], A[qi * np + pj], A[qi * np + qj], z00, z01,
                       z10, z11);
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
          rotate_v(cs_c[i], cs_s[i], V[k * np + p], V[k * np + q], V[k * np + p],
                   V[k * np + q]);
        }
      }
      __syncthreads();
    }
    ++sweeps;
  }
  write_sorted(A, V, np, n, B.diag, B.perm, w_b, V_b, tid, nt);
  if (tid == 0) info_b[0] = converged ? sweeps : -1;
}

template <typename T>
__global__ void small_eigh_cta_kernel(const T* __restrict__ A_in, T* __restrict__ w_out,
                                      T* __restrict__ V_out, int* __restrict__ info,
                                      int n, int max_sweeps) {
  extern __shared__ unsigned char smem_raw[];
  const int np = n + (n & 1);
  __shared__ R cs_c[MAX_PAIRS], cs_s[MAX_PAIRS], cs_t[MAX_PAIRS];
  __shared__ int pr_p[MAX_PAIRS], pr_q[MAX_PAIRS];
  __shared__ R red[33];
  __shared__ R diag[MAX_N];
  __shared__ int perm[MAX_N];
  JacobiBufs B;
  B.A = reinterpret_cast<R*>(smem_raw);  // np × np
  B.V = B.A + np * np;                     // np × np
  B.cs_c = cs_c;
  B.cs_s = cs_s;
  B.cs_t = cs_t;
  B.pr_p = pr_p;
  B.pr_q = pr_q;
  B.diag = diag;
  B.perm = perm;
  const int b = blockIdx.x;
  jacobi_cta(A_in + (size_t)b * n * n, w_out + (size_t)b * n,
             V_out + (size_t)b * n * n, info + b, n, max_sweeps, B, red);
}

// doubles of one matrix's global workspace
__host__ __device__ inline size_t global_work_doubles(int n) {
  const size_t np = n + (n & 1), h = np / 2;
  return 2 * np * np + 3 * h + n + (2 * h + n);  // the int tables as doubles
}

// small_eigh_global_kernel (any n): the one-CTA kernel's arithmetic with
// A, V, the rotations, pairs, diagonal and ranking in a global workspace
// (`work`, global_work_doubles(n) per matrix; 2·n²·8 B ≈ 1 MB at n = 246
// stays in the 50 MB L2), for the Rayleigh–Ritz matrices past the one-CTA
// kernel's shared memory (n > 96, a certificate at rank ≥ 31). Same
// threads as the one-CTA kernel at the same n, so the same bits where
// both run; up to 1024 of them, which caps its registers at 64.
template <typename T>
__global__ void __launch_bounds__(1024) small_eigh_global_kernel(const T* __restrict__ A_in,
                                         T* __restrict__ w_out, T* __restrict__ V_out,
                                         int* __restrict__ info, int n, int max_sweeps,
                                         R* __restrict__ work) {
  __shared__ R red[33];
  const int np = n + (n & 1), h = np / 2;
  const int b = blockIdx.x;
  R* base = work + (size_t)b * global_work_doubles(n);
  JacobiBufs B;
  B.A = base;
  B.V = B.A + (size_t)np * np;
  B.cs_c = B.V + (size_t)np * np;
  B.cs_s = B.cs_c + h;
  B.cs_t = B.cs_s + h;
  B.diag = B.cs_t + h;
  B.pr_p = reinterpret_cast<int*>(B.diag + n);
  B.pr_q = B.pr_p + h;
  B.perm = B.pr_q + h;
  jacobi_cta(A_in + (size_t)b * n * n, w_out + (size_t)b * n,
             V_out + (size_t)b * n * n, info + b, n, max_sweeps, B, red);
}

// ---------------------------------------------------------------------------
// the one-warp kernel

// Σ A[e]² over the np × np entries (OFF: off the diagonal only) in the
// one-CTA kernel's order for `nt` threads: thread t's strided sum over
// e = t, t + nt (nt > np²/2 for every n, so at most two terms), a
// __shfl_down tree per warp of threads, a tree over the warps' sums. The
// nt / 32 virtual warps go to the CTA's warps VCHUNK at a time; in a chunk
// lane l plays thread 32v + l of each virtual warp v, branch-free, so that
// the loads and shuffles overlap (a term past the end, or on the diagonal
// when OFF, adds an exact 0 to a sum that is ≥ 0), and lane 0 leaves warp
// v's sum in red[v]. After a __syncthreads every warp takes the tree over
// red. `tab[e]` is entry e's offset in A, with DIAG set on the diagonal.
// Every thread returns the total.
constexpr int VCHUNK = 8;
constexpr unsigned short DIAG = 0x8000;

template <bool OFF>
__device__ R replay_sum(const R* A, const unsigned short* tab, R* red, int size,
                        int nt, int lane, int warp, int nwarps) {
  const int nw = nt >> 5;
  for (int v0 = warp * VCHUNK; v0 < nw; v0 += nwarps * VCHUNK) {
    R part[VCHUNK];
#pragma unroll
    for (int k = 0; k < VCHUNK; ++k) {
      const int e0 = (v0 + k) * 32 + lane, e1 = e0 + nt;
      const int x0 = tab[e0 < size ? e0 : 0], x1 = tab[e1 < size ? e1 : 0];
      const R a0 = A[x0 & ~DIAG], a1 = A[x1 & ~DIAG];
      const R b0 = e0 < size && !(OFF && (x0 & DIAG)) ? a0 : R(0);
      const R b1 = e1 < size && !(OFF && (x1 & DIAG)) ? a1 : R(0);
      part[k] = R(0);
      part[k] += b0 * b0;
      part[k] += b1 * b1;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < VCHUNK; ++k) part[k] += __shfl_down_sync(FULL, part[k], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < VCHUNK; ++k)
        if (v0 + k < nw) red[v0 + k] = part[k];
    }
  }
  __syncthreads();
  R x = lane < nw ? red[lane] : R(0);
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
  return __shfl_sync(FULL, x, 0);
}

// a round's rotations, by slot (the one-warp kernel keeps two: this
// round's and the next one's)
struct Round {
  R c[WARP_N / 2], s[WARP_N / 2], t[WARP_N / 2];
  int pq[WARP_N / 2];  // the slot's pair, p | q << 8
};

// row u's entries after the round `r` at the columns of slot j: (at p_j,
// at q_j), computed from rows p_i and q_i of the old A (u in slot i ≠ j)
// as the one-CTA kernel's thread for the block computes them: for i < j
// the block (i, j), rows with Jᵢ then columns with Jⱼ; for i > j the block
// (j, i) = Xᵀ, rows with Jⱼ then columns with Jᵢ, transposed
__device__ __forceinline__ void row_entries(bool top, bool lo, R ci, R si, R cj, R sj,
                                            R x00, R x01, R x10, R x11, R& at_p,
                                            R& at_q) {
  R z00, z01, z10, z11;
  rotate_block(lo ? ci : cj, lo ? si : sj, lo ? cj : ci, lo ? sj : si, x00,
               lo ? x01 : x10, lo ? x10 : x01, x11, z00, z01, z10, z11);
  at_p = top ? z00 : (lo ? z10 : z01);
  at_q = top ? (lo ? z01 : z10) : z11;
}

// row u's diagonal entry after round rd (u in the pair (p, q) of slot i)
__device__ __forceinline__ R diag_entry(const R* A, const Round& r, int rd, int np,
                                        int u) {
  const int i = slot_of(rd, u, np);
  int p, q;
  pair_fast(rd, i, np, p, q);
  R pp, qq;
  rotate_diag(A[p * LD + p], A[q * LD + q], A[p * LD + q], r.t[i], pp, qq);
  return u == p ? pp : qq;
}

// entry (u, col) after round rd, u ≠ col
__device__ __forceinline__ R off_entry(const R* A, const Round& r, int rd, int np, int u,
                                       int col) {
  const int i = slot_of(rd, u, np), j = slot_of(rd, col, np);
  int p, q, pj, qj;
  pair_fast(rd, i, np, p, q);
  pair_fast(rd, j, np, pj, qj);
  R at_p, at_q;
  row_entries(u == p, i < j, r.c[i], r.s[i], r.c[j], r.s[j], A[p * LD + pj],
              A[p * LD + qj], A[q * LD + pj], A[q * LD + qj], at_p, at_q);
  return i == j ? R(0) : (col == pj ? at_p : at_q);
}

// the one-warp kernel: W update warps, each JB column pairs at a time, and
// the rotation warp (warp W). The probe's build (SMALL_EIGH_SPLIT) sums
// clock64() cycles into split_clk: [0] rounds, [1] the rotation warp's, [2]
// update warp 0's, [3] its wait at the round's barrier, [4] the stop
// tests' and [5] their count, [6] the whole kernel
template <typename T>
__global__ void __launch_bounds__(32 * (W + 1))
    small_eigh_warp_kernel(const T* __restrict__ A_in, T* __restrict__ w_out,
                           T* __restrict__ V_out, int* __restrict__ info, int n,
                           int max_sweeps, int nt_ref) {
  __shared__ R A[2][WARP_N * LD];
  __shared__ R V[WARP_N * LD];
  __shared__ Round rounds[2];
  __shared__ R red[32];
  __shared__ R diag[WARP_N];
  __shared__ int perm[WARP_N];
  __shared__ unsigned short tab[WARP_N * WARP_N];

  const int np = n + (n & 1), h = np / 2, size = np * np;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nthreads = 32 * (W + 1);
  const T* Ab = A_in + (size_t)b * n * n;
#ifdef SMALL_EIGH_SPLIT
  long long ck[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long k_start = clock64();
#endif

  // stage the input (coalesced), then mirror its lower triangle into A[0]
  R* S = A[1];
#pragma unroll 4
  for (int e = tid; e < n * n; e += nthreads) {
    const int i = e / n;
    S[i * LD + e - i * n] = R(Ab[e]);
  }
  __syncthreads();
  for (int e = tid; e < np * WARP_N; e += nthreads) {
    const int i = e >> 5, j = e & 31;
    if (j >= np) continue;
    R a = R(0);
    if (i < n && j < n) a = i >= j ? S[i * LD + j] : S[j * LD + i];
    A[0][i * LD + j] = a;
    V[i * LD + j] = i == j ? R(1) : R(0);
    tab[i * np + j] = (unsigned short)((i * LD + j) | (i == j ? DIAG : 0));
  }
  __syncthreads();
  const R norm2 = replay_sum<false>(A[0], tab, red, size, nt_ref, lane, w, W + 1);
  if (!isfinite(norm2)) {
    const R nan = R(0) / R(0);
    for (int e = tid; e < n * n; e += nthreads) V_out[(size_t)b * n * n + e] = T(nan);
    for (int i = tid; i < n; i += nthreads) w_out[(size_t)b * n + i] = T(nan);
    if (tid == 0) info[b] = 0;
    return;
  }
  // round 0's rotations, from A as it is
  if (w == W && lane < h) {
    int p, q;
    pair_fast(0, lane, np, p, q);
    R c, s, t;
    rotation(A[0][p * LD + p], A[0][q * LD + q], A[0][p * LD + q], c, s, t);
    rounds[0].c[lane] = c;
    rounds[0].s[lane] = s;
    rounds[0].t[lane] = t;
    rounds[0].pq[lane] = p | (q << 8);
  }
  __syncthreads();
  const R tol2 = EPS * EPS * norm2;
  int sweeps = 0, cur = 0, par = 0;
  bool converged = false;
  for (;;) {
#ifdef SMALL_EIGH_SPLIT
    const long long s0 = clock64();
#endif
    const R off2 = replay_sum<true>(A[cur], tab, red, size, nt_ref, lane, w, W + 1);
#ifdef SMALL_EIGH_SPLIT
    ck[4] += clock64() - s0;
    ck[5] += 1;
#endif
    if (off2 <= tol2) {
      converged = true;
      break;
    }
    if (sweeps == max_sweeps) break;
    for (int rd = 0; rd < np - 1; ++rd) {
      const R* Ac = A[cur];
      const Round& r = rounds[par];
#ifdef SMALL_EIGH_SPLIT
      const long long t0 = clock64();
#endif
      if (w == W) {
        // the next round's rotations, from the entries this round leaves
        // at its pairs (computed here as the update computes them)
        if (lane < h) {
          const int nrd = rd + 1 == np - 1 ? 0 : rd + 1;
          int p, q;
          pair_fast(nrd, lane, np, p, q);
          R c, s, t;
          const R app = diag_entry(Ac, r, rd, np, p), aqq = diag_entry(Ac, r, rd, np, q);
          rotation(app, aqq, off_entry(Ac, r, rd, np, p, q), c, s, t);
          // every index is in one next pair: this round's diagonal block
          // of the new A, for the update warps
          R* An = A[cur ^ 1];
          An[p * LD + p] = app;
          An[q * LD + q] = aqq;
          An[p * LD + partner(rd, p, np)] = R(0);
          An[q * LD + partner(rd, q, np)] = R(0);
          Round& nr = rounds[par ^ 1];
          nr.c[lane] = c;
          nr.s[lane] = s;
          nr.t[lane] = t;
          nr.pq[lane] = p | (q << 8);
        }
      } else if (lane < np) {
        // lane u's row of the new A, and of V, at this warp's column pairs
        const int i = slot_of(rd, lane, np), p = r.pq[i] & 255, q = r.pq[i] >> 8;
        const bool top = lane == p;
        const R ci = r.c[i], si = r.s[i];
        const R *Ap = Ac + p * LD, *Aq = Ac + q * LD;
        R* out = A[cur ^ 1] + lane * LD;
        R* v = V + lane * LD;
        // JB column pairs at a time: every load of a batch before its
        // stores, so that the loads overlap (the stores may alias them)
        for (int j0 = w; j0 < h; j0 += JB * W) {
          int pj[JB], qj[JB];
          R cj[JB], sj[JB], x[JB][4], vp[JB], vq[JB];
#pragma unroll
          for (int k = 0; k < JB; ++k) {
            const int j = min(j0 + k * W, h - 1), pqj = r.pq[j];  // past the end:
            pj[k] = pqj & 255;                                      // not stored
            qj[k] = pqj >> 8;
            cj[k] = r.c[j];
            sj[k] = r.s[j];
            x[k][0] = Ap[pj[k]];
            x[k][1] = Ap[qj[k]];
            x[k][2] = Aq[pj[k]];
            x[k][3] = Aq[qj[k]];
            vp[k] = v[pj[k]];
            vq[k] = v[qj[k]];
          }
          // no branch: a store that must not land (the own pair, whose
          // entries are the rotation warp's, a pair past the end, V's pad
          // row) goes to the row's padding column WARP_N, never read
#pragma unroll
          for (int k = 0; k < JB; ++k) {
            const int j = j0 + k * W;
            R at_p, at_q, nvp, nvq;
            row_entries(top, i < j, ci, si, cj[k], sj[k], x[k][0], x[k][1], x[k][2],
                        x[k][3], at_p, at_q);
            rotate_v(cj[k], sj[k], vp[k], vq[k], nvp, nvq);
            const bool a_ok = j < h && j != i, v_ok = j < h && lane < n;
            out[a_ok ? pj[k] : WARP_N] = at_p;
            out[a_ok ? qj[k] : WARP_N] = at_q;
            v[v_ok ? pj[k] : WARP_N] = nvp;
            v[v_ok ? qj[k] : WARP_N] = nvq;
          }
        }
      }
#ifdef SMALL_EIGH_SPLIT
      const long long t1 = clock64();
#endif
      __syncthreads();
#ifdef SMALL_EIGH_SPLIT
      const long long t2 = clock64();
      ck[0] += 1;
      ck[w == W ? 1 : 2] += t1 - t0;
      ck[3] += t2 - t1;
#endif
      cur ^= 1;
      par ^= 1;
    }
    ++sweeps;
  }
  write_sorted(A[cur], V, LD, n, diag, perm, w_out + (size_t)b * n,
               V_out + (size_t)b * n * n, tid, nthreads);
  if (tid == 0) info[b] = converged ? sweeps : -1;
#ifdef SMALL_EIGH_SPLIT
  if (b == 0 && tid == 0) {
    ck[6] = clock64() - k_start;
    for (int k = 0; k < 7; ++k)
      if (k != 1) split_clk[k] = ck[k];
  }
  if (b == 0 && tid == 32 * W) split_clk[1] = ck[1];
#endif
}

template <typename T>
int launch_cta(const void* A, void* w, void* V, void* info, int batch, int n,
               int max_sweeps, void* stream) {
  if (n < 1 || n > MAX_N || batch < 1) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  const int np = n + (n & 1);
  const size_t smem = 2 * (size_t)np * np * sizeof(double);
  if (!attr_set) {
    // the largest dynamic size any n needs; set once, outside any capture
    const int most = 2 * MAX_N * MAX_N * (int)sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(
        small_eigh_cta_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  small_eigh_cta_kernel<T><<<batch, cta_threads(n), smem, (cudaStream_t)stream>>>(
      (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_global(const void* A, void* w, void* V, void* info, int batch, int n,
                  int max_sweeps, void* work, void* stream) {
  if (n < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  small_eigh_global_kernel<T><<<batch, cta_threads(n), 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps, (R*)work);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp(const void* A, void* w, void* V, void* info, int batch, int n,
                int max_sweeps, void* stream) {
  if (n < 1 || n > WARP_N || batch < 1) return (int)cudaErrorInvalidValue;
  small_eigh_warp_kernel<T><<<batch, 32 * (W + 1), 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps, cta_threads(n));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cora_small_eigh_cta_f32(const void* A, void* w, void* V, void* info, int batch,
                            int n, int max_sweeps, void* stream) {
  return launch_cta<float>(A, w, V, info, batch, n, max_sweeps, stream);
}

int cora_small_eigh_cta_f64(const void* A, void* w, void* V, void* info, int batch,
                            int n, int max_sweeps, void* stream) {
  return launch_cta<double>(A, w, V, info, batch, n, max_sweeps, stream);
}

int cora_small_eigh_warp_f32(const void* A, void* w, void* V, void* info, int batch,
                             int n, int max_sweeps, void* stream) {
  return launch_warp<float>(A, w, V, info, batch, n, max_sweeps, stream);
}

int cora_small_eigh_warp_f64(const void* A, void* w, void* V, void* info, int batch,
                             int n, int max_sweeps, void* stream) {
  return launch_warp<double>(A, w, V, info, batch, n, max_sweeps, stream);
}

int cora_small_eigh_global_f32(const void* A, void* w, void* V, void* info,
                               int batch, int n, int max_sweeps, void* work,
                               void* stream) {
  return launch_global<float>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

int cora_small_eigh_global_f64(const void* A, void* w, void* V, void* info,
                               int batch, int n, int max_sweeps, void* work,
                               void* stream) {
  return launch_global<double>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

// doubles of the global kernel's workspace per matrix of size n
long long cora_small_eigh_global_work(int n) {
  return (long long)global_work_doubles(n);
}

int cora_small_eigh_max_n() { return MAX_N; }

int cora_small_eigh_warp_max_n() { return WARP_N; }

#ifdef SMALL_EIGH_SPLIT
// the split build's cycles of the last one-warp launch (split_clk) into
// the host's out[8]
int cora_small_eigh_split_clocks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, split_clk, sizeof(split_clk));
}
#endif

}  // extern "C"
