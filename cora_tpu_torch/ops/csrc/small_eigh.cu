// small_eigh: the full eigendecomposition of small symmetric matrices
// for the Rayleigh–Ritz step of LOBPCG, by parallel-order (round-robin)
// cyclic Jacobi, in six kernels that give the same bits where they
// overlap: the one-warp kernel (n ≤ 32), the cluster family (32 < n ≤
// CLUSTER_MAX_N = 448) and its grid (to GRID_MAX_N = 1056), the stream
// route (past that), and two comparators routed to by no size: the global
// kernel (any n; the comparator past n = 96) and the one-CTA kernel (n ≤
// 96), the first design.
//
// Replaces `jnp.linalg.eigh` inside the JAX package's LOBPCG
// `lax.while_loop` (cora_tpu/ops/lobpcg.py:61; not a Pallas kernel). The
// port's loop runs as captured CUDA graphs, and `torch.linalg.eigh` checks
// its LAPACK `info` on the host, which synchronises and breaks a capture.
// Every kernel launches on the caller's stream, never synchronises, and
// leaves its convergence report in a device int.
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
//   shared memory, two __syncthreads phases a round. The first design, now
//   the comparator of the others (whose bits it defines).
// small_eigh_global_kernel (any n, forced only): the one-CTA kernel's body
//   (`jacobi_cta`, written once for both) with A, V and the round's tables
//   in a global workspace instead of shared memory, at the same thread
//   count, so the same bits where both run. 2·n²·8 B stays in L2 (~1 MB
//   at n = 246); each round's loads go through L1/L2, ~10 µs a round at n
//   = 99 on the H100 (PERF.md). The comparator of the cluster family, the
//   grid and the stream route past n = 96; one CTA a matrix, 11.4 s at n =
//   1062.
// small_eigh_cluster (3 ≤ n ≤ CLUSTER_MAX_N, routed 32 < n): three kernels
//   launched in a row, one launch count. (1) small_eigh_cluster_kernel: the
//   rounds on A over one thread-block cluster of C CTAs (C = cluster_size,
//   the smallest of 1, 2, 4, 8, 16 whose shared memory holds A twice; 16
//   is past the portable cluster size, admitted by its attribute), 1024
//   threads each. Rows of A are stored by circle-method position (slot,
//   side a/b), CTA c holding slots [cS, cS + S): the two rows of a pair
//   are on one CTA, and a round's shift moves each row one position
//   along the ring (a down a slot, b up), so only the two rows at each
//   CTA boundary cross through distributed shared memory, written by the
//   update straight into their next position of the other buffer. A
//   look-ahead warp per 32 slots computes the next round's pairs'
//   entries from this round's rows and rotations (as the one-warp
//   kernel's rotation warp does), then their rotations, and writes them
//   into every CTA's round table, while the other warps update the rows
//   with this round's: one barrier a round (__syncthreads at C = 1, else
//   cluster.sync). The diagonal and each pair's own entry travel in the
//   table, so no entry is read while it is rewritten. The rotations also
//   go to a log in the global workspace; V is not touched. (2)
//   small_eigh_vectors_kernel: V = J₁J₂… from the log, a warp per row of
//   V in registers by slot (a lane per ≤ 17 slots), the log staged through
//   shared memory up to VEC_ROUNDS rounds at a time. (3) small_eigh_sort_kernel:
//   `write_sorted`. Every entry of A sees `rotate_block` / `rotate_diag`
//   with the one-CTA kernel's operand order (a row's entry in the block
//   of slots i > j computed as block (j, i) and transposed, as the
//   one-warp kernel does), every entry of V `rotate_v` in the same round
//   order, and the stop test (once a sweep, on CTA 0, reading the other
//   CTAs' rows through distributed shared memory) replays the one-CTA
//   kernel's sums for its thread count (`cta_order_sum`): the same bits.
//   The kernel is written once, templated on how its CTAs reach each
//   other (`ClusterLink`, `GridLink`).
// small_eigh_grid (routed CLUSTER_MAX_N < n ≤ GRID_MAX_N): the same three
//   kernels, (1) on G = grid_size(n) CTAs of a cooperative launch, one per
//   SM (`GridLink`): the rows that cross a CTA boundary go through an L2
//   mailbox and the look-ahead's table through a global round table, both
//   copied into each CTA's shared memory after the round's barrier, a
//   monotonic counter in global memory (a release add, an acquire spin;
//   faster than grid.sync() on the H100, scripts/probe_cluster_sync.py);
//   the stop test on CTA 0 reads the rows every CTA wrote to the
//   workspace. The launch raises where the card cannot hold G CTAs at
//   once; a CUDA graph captures it (checked by the probe). It takes a
//   batch's matrices in turn inside one launch.
// small_eigh_stream (routed n > GRID_MAX_N, any n ≥ STREAM_MIN_N forced):
//   the grid's shared memory holds A's rows twice and the table; past
//   1056 it does not, so (1') small_eigh_stream_kernel keeps A by index in
//   the workspace (8·n_p² B: 9 MB at n = 1062, 36 MB at 2112, in the 50 MB
//   L2 to about n = 2500, past which the same kernel reads HBM), on G =
//   stream_size(n) co-resident CTAs (the grid's launch and counter
//   barrier). In round rd CTA c owns the rows of its slots and rewrites
//   every entry of them in place, from those rows alone, with each entry's
//   operations in the one-CTA kernel's order (`block_rows_rn`); an entry
//   is written only by the CTA that owns its row, so rows never move
//   between CTAs and one barrier a round suffices. Warp 0's look-ahead
//   lane per slot updates the block its next pair's entry comes from
//   itself (the update warps skip it), so nothing is read while it is
//   rewritten; the diagonal travels in the table, never read from A. The
//   stop test's virtual warps are spread over the CTAs, every CTA taking
//   the tree over their sums. Then V from the log ((2), or past h = 544
//   (2') with V's rows in shared memory by index) and (3). It takes n to
//   STREAM_MAX_N = 19 370, where (3)'s ranking fills the shared memory; the
//   card's memory runs out first (the log: ~80 GB at n ≈ 18 000).
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

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

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
// column: the sign from its largest-magnitude entry (threads tid of nt;
// the columns col0, col0 + step, … of warps col0 … of this CTA's, the
// ranked eigenvalues written where write_w)
template <typename T>
__device__ void write_sorted(const R* A, const R* V, int ld, int n, R* diag,
                             int* perm, T* w_out, T* V_out, int tid, int nt,
                             int col0 = 0, int step = 0, bool write_w = true) {
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
    if (write_w) w_out[rank] = T(di);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int col = col0 + warp; col < n; col += step ? step : nwarps) {
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

// ---------------------------------------------------------------------------
// the cluster family (small_eigh_cluster, small_eigh_grid)

constexpr int CLUSTER_MAX_N = 448;
constexpr int CLUSTER_MAX_C = 16;
// the grid route: G co-resident CTAs, one per SM, at most GRID_MAX_G (the
// H100's SMs; the launch checks the card's), for n to GRID_MAX_N
constexpr int GRID_MAX_N = 1056;
constexpr int GRID_MAX_G = 132;
constexpr int CLUSTER_THREADS = 1024;
// the sm_90 opt-in shared memory of a block, less room for the kernel's
// static shared memory
constexpr int CLUSTER_SMEM = 232448 - 1024;
constexpr int VEC_THREADS = 128;  // the vectors kernel: a warp per row of V
constexpr int VEC_ROWS = VEC_THREADS / 32;
constexpr int VEC_ROUNDS = 32;    // rounds of the log staged at once, at most
constexpr int VEC_SMEM = 232448;  // the staging's shared memory, at most
constexpr int VEC_MAX_R = 17;     // slots a lane holds: h ≤ 32·17 = 544
// to 7 slots a lane (the cluster family's n), each round's (c, s) loaded a
// round ahead; past it not: two rounds' (c, s), a double2 each a slot,
// would take 8·RR more registers, past the 255 a thread has at RR = 17
// (189 without them)
constexpr int VEC_AHEAD_R = 7;
// the stop test's verdicts, and the status of a matrix with a non-finite
// entry
enum { GO = 0, DONE = 1, CAP = 2, BAD = 3 };
constexpr int NONFINITE = -2147483647 - 1;
static_assert(GRID_MAX_N <= 64 * VEC_MAX_R, "a lane holds at most VEC_MAX_R slots");

#ifdef SMALL_EIGH_SPLIT
// the probe's build: matrix 0's clock64() cycles in the cluster family, as
// `small_eigh_cluster_kernel` says
__device__ long long split_clu[12];
#endif

// doubles of the kernel's dynamic shared memory at n on P CTAs: the rows
// (two buffers × two sides × S slots × np + 1), the round table (two
// parities × seven doubles × h, rounded up to even: (c, s), t, three
// entries, the pair as an int) and the rows' next positions (2·S 32-bit
// addresses)
__host__ __device__ inline int cluster_smem_doubles(int n, int P) {
  const int np = n + (n & 1), h = np / 2, S = (h + P - 1) / P;
  return 4 * S * (np + 1) + 2 * (7 * h + (h & 1)) + S;
}

// whether P CTAs hold n: the shared memory, and S ≥ 2 slots a CTA (the
// look-ahead reads the rows of one of a next pair's two source slots, the
// one on its own CTA: a CTA between two others needs two slots for that;
// the last CTA that holds any may hold one, slot h − 1, the source of its
// own a; CTAs past it hold none and only take part in the barriers)
__host__ __device__ inline bool parts_fit(int n, int P) {
  if (n < 3 || P < 1) return false;
  const int h = (n + (n & 1)) / 2, S = (h + P - 1) / P;
  if (P > 1 && S < 2) return false;
  return (size_t)cluster_smem_doubles(n, P) * sizeof(double) <= (size_t)CLUSTER_SMEM;
}

__host__ __device__ inline bool cluster_fits(int n, int C) {
  return C <= CLUSTER_MAX_C && parts_fit(n, C);
}

__host__ __device__ inline bool grid_fits(int n, int G) {
  return n <= GRID_MAX_N && G >= 2 && G <= GRID_MAX_G && parts_fit(n, G);
}

// the smallest power of two that holds n (0: none does)
__host__ __device__ inline int cluster_size(int n) {
  for (int C = 1; C <= CLUSTER_MAX_C; C *= 2)
    if (cluster_fits(n, C)) return C;
  return 0;
}

// the most CTAs that hold n with S ≥ 2 pairs each, at most GRID_MAX_G: the
// smallest S whose ⌈h/S⌉ CTAs the card holds (0: none does). A round's
// update on a CTA moves S·h entries through its shared memory, which bounds
// it; more CTAs cost the barrier little (scripts/probe_cluster_sync.py)
__host__ __device__ inline int grid_size(int n) {
  const int h = (n + (n & 1)) / 2;
  for (int S = 2; S <= h; ++S) {
    const int G = (h + S - 1) / S;
    if (G <= GRID_MAX_G) return grid_fits(n, G) ? G : 0;
  }
  return 0;
}

// doubles of one matrix's global workspace: the rotation log ((c, s) per
// slot per round, up to max_sweeps·(np − 1) rounds and the one computed
// ahead), V (np × np), A (np × np: its diagonal written at the end, so
// that `write_sorted` reads it as it reads A; on the grid also the stop
// test's copy of the rows), two ints (info, rounds); even, so that every
// matrix's log is 16-byte aligned
__host__ __device__ inline size_t cluster_work_doubles(int n, int max_sweeps) {
  const size_t np = n + (n & 1), h = np / 2, m = np - 1;
  const size_t total = 2 * ((size_t)max_sweeps * m + 1) * h + 2 * np * np + 1;
  return total + (total & 1);
}

// doubles the grid adds after its matrices' workspaces, shared by them: the
// round table (two parities, as in shared memory), the mailbox (two
// buffers × G CTAs × two sides × np) and the barrier's count with the stop
// test's verdict
__host__ __device__ inline size_t grid_extra_doubles(int n, int G) {
  const size_t np = n + (n & 1), h = np / 2;
  const size_t total = 2 * (7 * h + (h & 1)) + 4 * (size_t)G * np + 1;
  return total + (total & 1);
}

// the index at position (slot i, side) in round rd: side 0 is the circle
// method's a = rd + i, side 1 its b = rd − i (slot 0: the fixed m = np − 1)
__device__ __forceinline__ int index_at(int rd, int i, int side, int m) {
  if (side == 0) {
    const int a = rd + i;
    return a >= m ? a - m : a;
  }
  if (i == 0) return m;
  const int b = rd - i;
  return b < 0 ? b + m : b;
}

// where the index at (i, side) sits in the next round: a moves down a slot
// (slot 0's a to slot 1's b), b up a slot (the last slot's b to its a),
// the fixed index stays
__device__ __forceinline__ void next_pos(int i, int side, int h, int& ni, int& ns) {
  if (side == 0) {
    ni = i > 0 ? i - 1 : 1;
    ns = i > 0 ? 0 : 1;
  } else if (i == 0) {
    ni = 0;
    ns = 1;
  } else if (i < h - 1) {
    ni = i + 1;
    ns = 1;
  } else {
    ni = h - 1;
    ns = 0;
  }
}

// where the index at (k, side) of the next round sits in this one (the
// inverse of next_pos)
__device__ __forceinline__ void prev_pos(int k, int side, int h, int& pi, int& ps) {
  if (side == 0) {
    pi = k < h - 1 ? k + 1 : h - 1;
    ps = k < h - 1 ? 0 : 1;
  } else if (k >= 2) {
    pi = k - 1;
    ps = 1;
  } else {
    pi = 0;
    ps = k == 1 ? 0 : 1;
  }
}

// `p` (an address in this CTA's shared memory) in CTA `cta`'s
template <class P>
__device__ __forceinline__ P* cta_ptr(P* p, int cta, int rank) {
  return cta == rank ? p : cg::this_cluster().map_shared_rank(p, cta);
}

// The one-CTA kernel's `block_sum` of its threads' strided sums, replayed
// for nt of this CTA's threads (nt ≤ 1024): thread t < nt sums the terms
// entry(e)² for e = t, t + nt, … of the np × np entries in order (OFF: an
// exact 0 on the diagonal, which adds nothing to a sum ≥ 0), then the
// __shfl_down tree of each warp and the tree over the warps' sums. Every
// thread returns the total.
template <bool OFF, class Entry>
__device__ R cta_order_sum(const Entry& entry, int np, int nt, R* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  R part = R(0);
  if (tid < nt) {
    const int du = nt / np, dv = nt - du * np;
    int u = tid / np, v = tid - u * np;
    for (int e = tid; e < np * np; e += nt) {
      const R a = entry(u, v);
      const R x = OFF && u == v ? R(0) : a;
      part += x * x;
      u += du;
      v += dv;
      if (v >= np) {
        v -= np;
        ++u;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(FULL, part, o);
  if (lane == 0 && warp < nw) red[warp] = part;
  __syncthreads();
  R x = lane < nw ? red[lane] : R(0);
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
  x = __shfl_sync(FULL, x, 0);
  __syncthreads();  // red is reused by the next sum
  return x;
}

// `rotate_block`, `rotate_v` and `rotate_diag` with their contraction
// written out: nvcc contracts each a·b ± c·d of them in the other kernels
// as fma(a, b, ±round(c·d)) (their SASS), but may choose the other product
// where the code around an inlined copy differs; the cluster family states
// it, so that its bits do not hang on that choice
__device__ __forceinline__ void rotate_block_rn(R cr, R sr, R cc, R sc, R x00, R x01,
                                                R x10, R x11, R& z00, R& z01, R& z10,
                                                R& z11) {
  const R y00 = __fma_rn(cr, x00, -__dmul_rn(sr, x10));
  const R y01 = __fma_rn(cr, x01, -__dmul_rn(sr, x11));
  const R y10 = __fma_rn(sr, x00, __dmul_rn(cr, x10));
  const R y11 = __fma_rn(sr, x01, __dmul_rn(cr, x11));
  z00 = __fma_rn(cc, y00, -__dmul_rn(sc, y01));
  z01 = __fma_rn(sc, y00, __dmul_rn(cc, y01));
  z10 = __fma_rn(cc, y10, -__dmul_rn(sc, y11));
  z11 = __fma_rn(sc, y10, __dmul_rn(cc, y11));
}

__device__ __forceinline__ void rotate_v_rn(R c, R s, R vp, R vq, R& np_, R& nq_) {
  np_ = __fma_rn(c, vp, -__dmul_rn(s, vq));
  nq_ = __fma_rn(s, vp, __dmul_rn(c, vq));
}

__device__ __forceinline__ void rotate_diag_rn(R app, R aqq, R apq, R t, R& pp, R& qq) {
  pp = __fma_rn(-t, apq, app);
  qq = __fma_rn(t, apq, aqq);
}

// the block of slots (i, j), i ≠ j, as rows p_i, q_i see it after the
// round: their entries at columns (p_j, q_j), computed as the one-CTA
// kernel's thread for the block (min, max) computes them (lo: i < j; for i >
// j the block (j, i) and transposed), through rotate_block_rn
__device__ __forceinline__ void block_rows_rn(bool lo, R ci, R si, R cj, R sj, R x00,
                                              R x01, R x10, R x11, R& p_at_p, R& p_at_q,
                                              R& q_at_p, R& q_at_q) {
  R z00, z01, z10, z11;
  rotate_block_rn(lo ? ci : cj, lo ? si : sj, lo ? cj : ci, lo ? sj : si, x00,
                  lo ? x01 : x10, lo ? x10 : x01, x11, z00, z01, z10, z11);
  p_at_p = z00;
  p_at_q = lo ? z01 : z10;
  q_at_p = lo ? z10 : z01;
  q_at_q = z11;
}

// `row_entries` through rotate_block_rn: row p_i's (top) or q_i's
__device__ __forceinline__ void row_entries_rn(bool top, bool lo, R ci, R si, R cj, R sj,
                                               R x00, R x01, R x10, R x11, R& at_p,
                                               R& at_q) {
  R pp, pq, qp, qq;
  block_rows_rn(lo, ci, si, cj, sj, x00, x01, x10, x11, pp, pq, qp, qq);
  at_p = top ? pp : qp;
  at_q = top ? pq : qq;
}

// next round's entries of one pair for the look-ahead
struct Ahead {
  R c, s, t, app, aqq, apq;
  int pq;
};

// A round's table as the look-ahead and the update read it: (c, s) and p |
// q << 16 of every slot; t, the diagonal at p and q and the pair's own entry
// that the round starts from, by slot (the cluster family's CTAs hold every
// slot's, the grid's and the stream route's those of their own slots and
// their neighbours')
struct TabView {
  const double2* cs;
  const int* pq;
  const R *t, *dp, *dq, *apq;
  // the diagonal the round leaves at index u of slot k's pair
  __device__ __forceinline__ R diag_after(int k, int u) const {
    R pp, qq;
    rotate_diag_rn(dp[k], dq[k], apq[k], t[k], pp, qq);
    return u == (pq[k] & 0xffff) ? pp : qq;
  }
};

// the view of a table laid out as the cluster family's shared memory and
// the grid's global table hold it (7h doubles: (c, s), t, dp, dq, apq, pq)
__device__ __forceinline__ TabView full_view(const R* tb, int h) {
  return TabView{reinterpret_cast<const double2*>(tb), reinterpret_cast<const int*>(tb + 6 * h),
                 tb + 2 * h, tb + 3 * h, tb + 4 * h, tb + 5 * h};
}

// Next round's slot k: its two indices' positions in this round (ia, sa),
// (ib, sb), the indices ua, ub there, and of its two source slots the one on
// this CTA (L, index uL) and the other (O, uO)
struct AheadSrc {
  int ia, ib, ua, ub, L, O, uL, uO;
};

__device__ __forceinline__ AheadSrc ahead_src(int k, int rd, int h, int m, int s0, int s1) {
  AheadSrc a;
  int sa, sb;
  prev_pos(k, 0, h, a.ia, sa);
  prev_pos(k, 1, h, a.ib, sb);
  a.ua = index_at(rd, a.ia, sa, m);
  a.ub = index_at(rd, a.ib, sb, m);
  const bool own_a = a.ia >= s0 && a.ia < s1;
  a.L = own_a ? a.ia : a.ib;
  a.O = own_a ? a.ib : a.ia;
  a.uL = own_a ? a.ua : a.ub;
  a.uO = own_a ? a.ub : a.ua;
  return a;
}

// The table entries of next round's slot k from this round's table and the
// entry the round leaves between k's two indices (row uL's at columns p_O
// and q_O): the diagonal at each index (its source pair's rotate_diag), the
// entry, then the rotation
__device__ __forceinline__ Ahead ahead_finish(const AheadSrc& src, const TabView& tb, R at_p,
                                              R at_q) {
  const R da = tb.diag_after(src.ia, src.ua), db = tb.diag_after(src.ib, src.ub);
  Ahead a;
  a.apq = src.uO == (tb.pq[src.O] & 0xffff) ? at_p : at_q;
  a.app = src.ua < src.ub ? da : db;
  a.aqq = src.ua < src.ub ? db : da;
  a.pq = src.ua < src.ub ? src.ua | (src.ub << 16) : src.ub | (src.ua << 16);
  rotation(a.app, a.aqq, a.apq, a.c, a.s, a.t);
  return a;
}

// The table entries of next round's slot k (this CTA's), computed from
// this round's table `tb` and the rows of whichever of k's two source
// slots is on this CTA (`rows_cur`: buffer cur), as the update computes
// them (row_entries from the source slot's rows at the other's columns).
__device__ __forceinline__ Ahead ahead_slot(int k, int rd, const TabView& tb, const R* rows_cur,
                                            int S, int ld, int h, int m, int s0, int s1) {
  const AheadSrc src = ahead_src(k, rd, h, m, s0, s1);
  const int L = src.L, pqL = tb.pq[L], pqO = tb.pq[src.O];
  const int pL = pqL & 0xffff, pO = pqO & 0xffff, qO = pqO >> 16;
  const int ps = index_at(rd, L, 0, m) == pL ? 0 : 1;
  const R* rp = rows_cur + (size_t)(ps * S + L - s0) * ld;
  const R* rq = rows_cur + (size_t)((1 - ps) * S + L - s0) * ld;
  const double2 cL = tb.cs[L], cO = tb.cs[src.O];
  R at_p, at_q;
  row_entries_rn(src.uL == pL, L < src.O, cL.x, cL.y, cO.x, cO.y, rp[pO], rp[qO], rq[pO],
                 rq[qO], at_p, at_q);
  return ahead_finish(src, tb, at_p, at_q);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a double into shared memory at a shared::cluster address (this CTA's or
// another's in the cluster)
__device__ __forceinline__ void st_cluster(unsigned addr, R v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(addr), "d"(v) : "memory");
}

// a double into this CTA's shared memory at a shared::cta address
__device__ __forceinline__ void st_cta(unsigned addr, R v) {
  asm volatile("st.shared.f64 [%0], %1;" ::"r"(addr), "d"(v) : "memory");
}

// this CTA's shared::cta address `a` in CTA `cta`'s window of the cluster
__device__ __forceinline__ unsigned map_cluster(unsigned a, int cta) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(cta));
  return out;
}

// a generic address's double (this CTA's shared memory or global memory)
__device__ __forceinline__ void st_generic(R* p, R v) {
  asm volatile("st.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory");
}

// Where a row's update goes, one column at a time: this CTA's shared
// memory, another's in the cluster, or a generic address (the grid's: this
// CTA's shared memory, or the L2 mailbox at a boundary)
struct CtaStore {
  unsigned a;
  __device__ void operator()(int col, R v) const { st_cta(a + 8 * col, v); }
};
struct ClusterStore {
  unsigned a;
  __device__ void operator()(int col, R v) const { st_cluster(a + 8 * col, v); }
};
struct GenericStore {
  R* p;
  __device__ void operator()(int col, R v) const { st_generic(p + col, v); }
};

// A row's update at one column slot j (lane's), MODE 0: every lane's j > i
// (block (i, j) as is), 1: every lane's j < i (block (j, i), transposed), 2:
// either, or j = i (the pair's own entries, 0; its diagonal travels in the
// table)
template <int MODE, class St>
__device__ __forceinline__ void update_lane(int i, int j, int pi, int qi, R ci, R si,
                                            const double2* cs, const int* pq, const R* rp,
                                            const R* rq, const St& op, const St& oq) {
  const int pqj = pq[j], pj = pqj & 0xffff, qj = pqj >> 16;
  const double2 cj = cs[j];
  const R x00 = rp[pj], x01 = rp[qj], x10 = rq[pj], x11 = rq[qj];
  R z00, z01, z10, z11;
  if (MODE == 0) {
    rotate_block_rn(ci, si, cj.x, cj.y, x00, x01, x10, x11, z00, z01, z10, z11);
    op(pj, z00);
    op(qj, z01);
    oq(pj, z10);
    oq(qj, z11);
  } else if (MODE == 1) {
    rotate_block_rn(cj.x, cj.y, ci, si, x00, x10, x01, x11, z00, z01, z10, z11);
    op(pj, z00);
    op(qj, z10);
    oq(pj, z01);
    oq(qj, z11);
  } else if (j == i) {
    op(qi, R(0));
    oq(pi, R(0));
  } else {
    const bool lo = i < j;
    rotate_block_rn(lo ? ci : cj.x, lo ? si : cj.y, lo ? cj.x : ci, lo ? cj.y : si, x00,
                    lo ? x01 : x10, lo ? x10 : x01, x11, z00, z01, z10, z11);
    op(pj, z00);
    op(qj, lo ? z01 : z10);
    oq(pj, lo ? z10 : z01);
    oq(qj, z11);
  }
}

// slot i's two rows (rp, rq; next positions op, oq) at the column slots
// j0 … j0 + 31, a lane each: a pass wholly on one side of i takes no select
template <class St>
__device__ __forceinline__ void update_pass(int i, int h, int j0, int lane, int pi, int qi,
                                            R ci, R si, const double2* cs, const int* pq,
                                            const R* rp, const R* rq, const St& op,
                                            const St& oq) {
  const int j = j0 + lane;
  if (i < j0) {
    if (j < h) update_lane<0>(i, j, pi, qi, ci, si, cs, pq, rp, rq, op, oq);
  } else if (i > j0 + 31) {
    update_lane<1>(i, j, pi, qi, ci, si, cs, pq, rp, rq, op, oq);
  } else if (j < h) {
    update_lane<2>(i, j, pi, qi, ci, si, cs, pq, rp, rq, op, oq);
  }
}

// one matrix's rounds on its CTA, `rank` of `parts`: slots [s0, s1), S a
// CTA; rows[buf][side][slot − s0][ld], the round table tab[par] (TAB
// doubles a parity), dst[side][slot − s0] (the next positions)
struct Part {
  int np, h, m, ld, S, s0, s1, Sc, TAB;
  size_t BUF;  // doubles of one buffer of rows
  R* rows;
  R* tab;
  unsigned* dst;
};

// The CTAs of one matrix as one thread-block cluster of C (the cluster
// route): rows cross at a boundary and the table goes to every CTA through
// distributed shared memory; the barrier is __syncthreads at C = 1, else
// cluster.sync(); the stop test on CTA 0 reads the others' rows in place.
struct ClusterLink {
  using Far = ClusterStore;
  int C;     // set by the launch
  int rank;  // set by begin()
  int* ctl;  // this CTA's verdict
  __device__ void begin(int* verdict) {
    rank = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
    ctl = verdict;
  }
  __device__ int parts() const { return C; }
  __device__ int first() const { return blockIdx.x / C; }
  __device__ int last() const { return blockIdx.x / C + 1; }
  __device__ void sync() {
    if (C == 1)
      __syncthreads();
    else
      cg::this_cluster().sync();
  }
  // the address `a` (this CTA's shared memory) in CTA `to`'s
  __device__ unsigned remote(unsigned a, int to) const { return map_cluster(a, to); }
  // slot k's entries of the table `par`: (c, s) and p | q << 16 into every
  // CTA's, the rest into this CTA's and its neighbours' (the look-ahead
  // reads them only for the slots next to its own)
  __device__ void publish(const Part& P, int par, int k, const Ahead& a) {
    const int h = P.h;
    for (int d = 0; d < C; ++d) {
      R* tb = cta_ptr(P.tab, d, rank) + par * P.TAB;
      reinterpret_cast<double2*>(tb)[k] = make_double2(a.c, a.s);
      reinterpret_cast<int*>(tb + 6 * h)[k] = a.pq;
      if (d >= rank - 1 && d <= rank + 1) {
        tb[2 * h + k] = a.t;
        tb[3 * h + k] = a.app;
        tb[4 * h + k] = a.aqq;
        tb[5 * h + k] = a.apq;
      }
    }
  }
  // the table of `par` complete on every CTA
  __device__ void after_table(const Part&, int) { sync(); }
  // a round ended: its rows (buffer cur) and next table (par) complete
  __device__ void after_round(const Part&, int, int) { sync(); }
  // where the row e = side·S + il of a boundary slot goes (buffer nxt)
  __device__ Far far(const Part& P, int e, int nxt) const {
    return Far{P.dst[e] + nxt * (unsigned)(P.BUF * sizeof(R))};
  }
  // CTA 0's stop test `f(entry)` on the rows of buffer `cur`, read in place,
  // and its verdict to every CTA
  template <class F>
  __device__ int decide(const Part& P, int cur, R*, F f) {
    if (rank == 0) {
      const int v = f([&](int u, int w) {
        const int slot = u == P.m ? 0 : (u < P.h ? u : P.m - u);
        const int side = u == P.m || u >= P.h, cta = slot / P.S;
        return cta_ptr(P.rows + cur * P.BUF + (size_t)(side * P.S + slot - cta * P.S) * P.ld,
                       cta, rank)[w];
      });
      if (threadIdx.x == 0)
        for (int d = 0; d < C; ++d) *cta_ptr(ctl, d, rank) = v;
    }
    sync();
    return *ctl;
  }
};

// The CTAs of one matrix as G co-resident CTAs of a cooperative launch (the
// grid route), which takes the batch's matrices in turn: the two rows that
// cross each CTA boundary go through an L2 mailbox, mail[buf][cta][side]
// [np] (side 0: the a-row arriving at the CTA's last slot, 1: the b-row at
// its first), double-buffered with the rows, and the look-ahead publishes
// to a global round table; after each barrier a CTA copies its incoming
// rows, every slot's rotations and pairs and its own and its neighbours'
// entries into its shared memory (L2 loads, __ldcg). The barrier is a
// monotonic count (a release add by one thread a CTA, an acquire spin; the
// launch zeroes it). The stop test: every CTA writes its rows into the
// matrix's workspace A by index, CTA 0 reads them from L2, its verdict comes
// back through `flag`.
struct GridLink {
  using Far = GenericStore;
  int G, batch;      // set by the launch
  R* gtab;           // the global round table, two parities
  R* mail;           // the mailbox
  unsigned* count;   // the barrier's count
  int* flag;         // the stop test's verdict
  int rank;          // set by begin()
  unsigned passed;   // barriers passed (every CTA the same)
  __device__ void begin(int*) {
    rank = blockIdx.x;
    passed = 0;
  }
  __device__ int parts() const { return G; }
  __device__ int first() const { return 0; }
  __device__ int last() const { return batch; }
  __device__ void sync() {
    __syncthreads();
    ++passed;
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
      const unsigned target = passed * (unsigned)G;
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      } while (v < target);
    }
    __syncthreads();
  }
  __device__ unsigned remote(unsigned, int) const { return 0; }  // never stored to
  __device__ void publish(const Part& P, int par, int k, const Ahead& a) {
    const int h = P.h;
    R* tb = gtab + par * P.TAB;
    reinterpret_cast<double2*>(tb)[k] = make_double2(a.c, a.s);
    reinterpret_cast<int*>(tb + 6 * h)[k] = a.pq;
    tb[2 * h + k] = a.t;
    tb[3 * h + k] = a.app;
    tb[4 * h + k] = a.aqq;
    tb[5 * h + k] = a.apq;
  }
  // After the barrier, into this CTA's shared memory: with `rows`, the
  // incoming rows from the mailbox into buffer cur; the table of `par`:
  // (c, s) and the pairs of every slot, t and the three entries of slots
  // s0 − 1 … s1. A thread issues all its L2 loads (IMPORT a pass) before
  // its stores, so that the copy waits on L2 about once.
  static constexpr int IMPORT = 4;
  __device__ void import(const Part& P, bool rows, int cur, int par) {
    const int np = P.np, h = P.h, hp = (h + 1) / 2;
    const int lo = P.s0 > 0 ? P.s0 - 1 : 0, hi = P.s1 < h ? P.s1 + 1 : h, w = hi - lo;
    const bool top = rows && P.Sc > 0 && P.s1 < h, bottom = rows && P.Sc > 0 && P.s0 > 0;
    const R* box = mail + (size_t)(cur * G + rank) * 2 * np;
    R* rc = P.rows + cur * P.BUF;
    const R* src = gtab + par * P.TAB;
    R* tb = P.tab + par * P.TAB;
    const int nrow = (top + bottom) * np, total = nrow + 2 * h + hp + 4 * w;
    for (int e0 = threadIdx.x; e0 < total; e0 += IMPORT * (int)blockDim.x) {
      R v[IMPORT];
      R* to[IMPORT];
#pragma unroll
      for (int k = 0; k < IMPORT; ++k) {
        const int e = e0 + k * blockDim.x;
        to[k] = nullptr;
        if (e >= total) continue;
        const R* from;
        if (e < nrow) {
          // the a-row at the last slot (top), then the b-row at the first
          const bool a = top && e < np;
          const int x = a || !top ? e : e - np;
          from = box + (a ? 0 : np) + x;
          to[k] = rc + (size_t)(a ? P.Sc - 1 : P.S) * P.ld + x;
        } else {
          const int t = e - nrow;
          int o;
          if (t < 2 * h) {
            o = t;
          } else if (t < 2 * h + hp) {
            o = 6 * h + t - 2 * h;
          } else {
            const int x = t - 2 * h - hp, q = x / w;
            o = (2 + q) * h + lo + x - q * w;
          }
          from = src + o;
          to[k] = tb + o;
        }
        v[k] = __ldcg(from);
      }
#pragma unroll
      for (int k = 0; k < IMPORT; ++k)
        if (to[k]) *to[k] = v[k];
    }
  }
  __device__ void after_table(const Part& P, int par) {
    sync();
    import(P, false, 0, par);
    __syncthreads();
  }
  // the incoming rows into buffer cur, the table of par
  __device__ void after_round(const Part& P, int cur, int par) {
    sync();
    import(P, true, cur, par);
    __syncthreads();
  }
  // where the row e = side·S + il of a boundary slot goes (buffer nxt): the
  // neighbour's mailbox where the shift takes it off this CTA, else its
  // next position here
  __device__ Far far(const Part& P, int e, int nxt) const {
    const int side = e >= P.S, il = e - side * P.S;
    if (side == 0 && il == 0 && P.s0 > 0)
      return Far{mail + (size_t)(nxt * G + rank - 1) * 2 * P.np};
    if (side == 1 && il == P.Sc - 1 && P.s1 < P.h)
      return Far{mail + ((size_t)(nxt * G + rank + 1) * 2 + 1) * P.np};
    int ni, ns;
    next_pos(P.s0 + il, side, P.h, ni, ns);
    return Far{P.rows + nxt * P.BUF + (size_t)(ns * P.S + ni - P.s0) * P.ld};
  }
  template <class F>
  __device__ int decide(const Part& P, int cur, R* Ad, F f) {
    const int np = P.np;
    const R* rows = P.rows + cur * P.BUF;
    for (int e = threadIdx.x; e < 2 * P.Sc * np; e += blockDim.x) {
      const int r = e / np, v = e - r * np;
      const int side = r >= P.Sc, il = side ? r - P.Sc : r;
      const int u = index_at(0, P.s0 + il, side, P.m);
      Ad[(size_t)u * np + v] = rows[(size_t)(side * P.S + il) * P.ld + v];
    }
    sync();
    if (rank == 0) {
      const int v = f([&](int u, int w) { return __ldcg(Ad + (size_t)u * np + w); });
      if (threadIdx.x == 0) *flag = v;
    }
    sync();
    return __ldcg(flag);
  }
};

// (1) The rounds on A of one matrix over the CTAs of a Link (one cluster
// of C; or the grid's G, which take a batch's matrices in turn). CTA
// `rank` holds slots [s0, s1) (S = ⌈h/parts⌉ each): rows[buf][side][slot −
// s0][np + 1]; the round table tab[par], per slot: (c, s), t, the diagonal
// at p and q and the pair's own entry that the round starts from, and p |
// q << 16; and dst[side][slot − s0], the shared::cta address (buffer 0) of
// the position each of its rows takes next round on this CTA (in the
// cluster, another's mapped at the boundaries). One or two look-ahead
// warps compute the next round's table for the CTA's slots, a lane per
// slot; the update warps update its rows, a column slot a lane, 32 a pass,
// passes wholly on one side of the slot taking no select. The probe's
// build (SMALL_EIGH_SPLIT) sums, for matrix 0 on CTA 0, clock64() cycles
// into split_clu: [0] rounds, [1] the look-ahead warp's body and [2] its
// wait at the round's barrier, [3] update warp 2's body and [4] its wait,
// [5] the stop tests and [6] their count, [7] the whole kernel.
template <typename T, class Link>
__device__ void jacobi_rounds(Link& L, const Part& P, const T* __restrict__ Ab,
                              T* __restrict__ w_b, T* __restrict__ V_b,
                              int* __restrict__ info_b, int n, int max_sweeps,
                              R* __restrict__ ws, R* red, bool probe) {
  const int np = P.np, h = P.h, m = P.m, ld = P.ld, S = P.S;
  const int s0 = P.s0, s1 = P.s1, Sc = P.Sc, TAB = P.TAB, rank = L.rank;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt_ref = cta_threads(n);
  const size_t BUF = P.BUF;
  R* rows = P.rows;
  R* tab = P.tab;
  unsigned* dst = P.dst;
  double2* rlog = reinterpret_cast<double2*>(ws);
  R* Ad = ws + 2 * ((size_t)max_sweeps * m + 1) * h + (size_t)np * np;
  int* status = reinterpret_cast<int*>(Ad + (size_t)np * np);
#ifdef SMALL_EIGH_SPLIT
  long long ck[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long k_start = clock64();
#else
  (void)probe;
#endif

  // the CTA's rows at their round-0 positions (the lower triangle,
  // mirrored, as the one-CTA kernel loads it), and where each goes next
  for (int e = tid; e < 2 * Sc * np; e += CLUSTER_THREADS) {
    const int r = e / np, v = e - r * np;
    const int side = r >= Sc, il = side ? r - Sc : r;
    const int u = index_at(0, s0 + il, side, m);
    R a = R(0);
    if (u < n && v < n) a = R(u >= v ? Ab[u * n + v] : Ab[v * n + u]);
    rows[(size_t)(side * S + il) * ld + v] = a;
  }
  for (int e = tid; e < 2 * Sc; e += CLUSTER_THREADS) {
    const int side = e >= Sc, il = side ? e - Sc : e;
    int ni, ns;
    next_pos(s0 + il, side, h, ni, ns);
    const int to = ni / S;
    const unsigned a = smem_addr(rows + (size_t)(ns * S + ni - to * S) * ld);
    dst[side * S + il] = to == rank ? a : L.remote(a, to);
  }
  L.sync();  // every CTA has started before any writes into another's
  // round 0's rotations of the CTA's slots, from A as loaded
  for (int il = tid; il < Sc; il += CLUSTER_THREADS) {
    const int k = s0 + il;
    int p, q;
    pair_fast(0, k, np, p, q);
    const int ps = index_at(0, k, 0, m) == p ? 0 : 1;
    const R* rp = rows + (size_t)(ps * S + il) * ld;
    const R* rq = rows + (size_t)((1 - ps) * S + il) * ld;
    Ahead a;
    a.app = rp[p];
    a.aqq = rq[q];
    a.apq = rp[q];
    a.pq = p | (q << 16);
    rotation(a.app, a.aqq, a.apq, a.c, a.s, a.t);
    L.publish(P, 0, k, a);
    rlog[k] = make_double2(a.c, a.s);
  }
  L.after_table(P, 0);
  // ‖A‖² and the first stop test on CTA 0, its verdict to every CTA
  R tol2 = R(0);
  int verdict = L.decide(P, 0, Ad, [&](const auto& entry) {
    const R norm2 = cta_order_sum<false>(
        [&](int u, int v) {
          return u < n && v < n ? R(u >= v ? Ab[u * n + v] : Ab[v * n + u]) : R(0);
        },
        np, nt_ref, red);
    if (!isfinite(norm2)) return (int)BAD;
    tol2 = EPS * EPS * norm2;
    const R off2 = cta_order_sum<true>(entry, np, nt_ref, red);
    return off2 <= tol2 ? (int)DONE : (max_sweeps == 0 ? (int)CAP : (int)GO);
  });
  if (verdict == BAD) {
    if (rank == 0) {
      const R nan = R(0) / R(0);
      for (int e = tid; e < n * n; e += CLUSTER_THREADS) V_b[e] = T(nan);
      for (int i = tid; i < n; i += CLUSTER_THREADS) w_b[i] = T(nan);
      if (tid == 0) {
        info_b[0] = 0;
        status[0] = NONFINITE;
      }
    }
    return;
  }

  // the look-ahead warps: 0, and 4 past 32 slots (one SM sub-partition:
  // the two chains interleave there); warp 8 logs the round's rotations.
  // The update warps: the NUW = 29 others, this one the wu-th (−1: none),
  // the 24 on the other three sub-partitions first, so that the five left
  // on the chains' take work only where a CTA holds more than 24 slots or
  // fewer than 15. A warp takes a slot at a time, its NJ passes of 32
  // column slots; where a CTA holds fewer than NUW slots, `per` warps split
  // each slot's passes (wu % Sc the slot, passes wu / Sc, + per, …)
  const int ahead2 = Sc <= 32 ? -1 : 4;
  const int NJ = (h + 31) / 32;
  constexpr int NUW = 29;
  const int wu = (warp & 3) ? warp - 1 - (warp >> 2) : (warp >= 12 ? 21 + (warp >> 2) : -1);
  const int per = Sc > 0 && Sc < NUW ? NUW / Sc : 1;
  const int first_slot = per == 1 ? wu : (wu < per * Sc ? wu % Sc : Sc);
  const int slot_step = per == 1 ? NUW : Sc;
  const int first_pass = per == 1 ? 0 : wu / Sc;
  const bool far_slots = L.parts() > 1;
  const unsigned BUFB = (unsigned)(BUF * sizeof(R));  // a buffer, in bytes
  int sweeps = 0, cur = 0, par = 0, g = 0;
  while (verdict == GO) {
    for (int rd = 0; rd < m; ++rd, ++g) {
      const int nxt = cur ^ 1;
      const R* tb = tab + par * TAB;
      const double2* cs = reinterpret_cast<const double2*>(tb);
      const int* pq = reinterpret_cast<const int*>(tb + 6 * h);
      const R* rows_cur = rows + cur * BUF;
#ifdef SMALL_EIGH_SPLIT
      const long long t0 = clock64();
#endif
      if (warp == 0 || warp == ahead2) {
        // next round's pair of slot s0 + il, a lane per slot
        const int il = (warp == 0 ? 0 : 32) + lane;
        if (il < Sc) {
          const Ahead a = ahead_slot(s0 + il, rd, full_view(tb, h), rows_cur, S, ld, h, m,
                                          s0, s1);
          L.publish(P, par ^ 1, s0 + il, a);
        }
      } else if (wu >= 0) {
        // the update warps: slot s0 + il's rows
        for (int il = first_slot; il < Sc; il += slot_step) {
          const int i = s0 + il;
          const int pqi = pq[i], pi = pqi & 0xffff, qi = pqi >> 16;
          const int ps = index_at(rd, i, 0, m) == pi ? 0 : 1;
          const R* rp = rows_cur + (size_t)(ps * S + il) * ld;
          const R* rq = rows_cur + (size_t)((1 - ps) * S + il) * ld;
          const double2 ci = cs[i];
          // a row crosses to a neighbour only from the CTA's first or last
          // slot
          if (far_slots && (il == 0 || il == Sc - 1)) {
            const auto op = L.far(P, ps * S + il, nxt), oq = L.far(P, (1 - ps) * S + il, nxt);
            for (int jp = first_pass; jp < NJ; jp += per)
              update_pass(i, h, 32 * jp, lane, pi, qi, ci.x, ci.y, cs, pq, rp, rq, op, oq);
          } else {
            const CtaStore op{dst[ps * S + il] + nxt * BUFB}, oq{dst[(1 - ps) * S + il] + nxt * BUFB};
            for (int jp = first_pass; jp < NJ; jp += per)
              update_pass(i, h, 32 * jp, lane, pi, qi, ci.x, ci.y, cs, pq, rp, rq, op, oq);
          }
        }
      } else if (warp == 8) {
        // this round's rotations into the log, early in the round, so that
        // no global store is still in flight at the barrier of the
        // look-ahead warp
        for (int il = lane; il < Sc; il += 32) rlog[(size_t)g * h + s0 + il] = cs[s0 + il];
      }
#ifdef SMALL_EIGH_SPLIT
      const long long t1 = clock64();
#endif
      L.after_round(P, nxt, par ^ 1);
#ifdef SMALL_EIGH_SPLIT
      if (probe && lane == 0 && (warp == 0 || warp == 2)) {
        const long long t2 = clock64();
        ck[warp == 0 ? 1 : 3] += t1 - t0;
        ck[warp == 0 ? 2 : 4] += t2 - t1;
        ck[0] += warp == 0;
      }
#endif
      cur = nxt;
      par ^= 1;
    }
    ++sweeps;
#ifdef SMALL_EIGH_SPLIT
    const long long s_0 = clock64();
#endif
    verdict = L.decide(P, cur, Ad, [&](const auto& entry) {
      const R off2 = cta_order_sum<true>(entry, np, nt_ref, red);
      return off2 <= tol2 ? (int)DONE : (sweeps == max_sweeps ? (int)CAP : (int)GO);
    });
#ifdef SMALL_EIGH_SPLIT
    ck[5] += clock64() - s_0;
    ck[6] += 1;
#endif
  }
  // the diagonal (the table of the next round 0) at each of the CTA's pairs
  const R* tb = tab + par * TAB;
  const int* pq = reinterpret_cast<const int*>(tb + 6 * h);
  for (int il = tid; il < Sc; il += CLUSTER_THREADS) {
    const int p = pq[s0 + il] & 0xffff, q = pq[s0 + il] >> 16;
    Ad[(size_t)p * np + p] = tb[3 * h + s0 + il];
    Ad[(size_t)q * np + q] = tb[4 * h + s0 + il];
  }
  if (rank == 0 && tid == 0) {
    status[0] = verdict == DONE ? sweeps : -1;
    status[1] = sweeps * m;
  }
#ifdef SMALL_EIGH_SPLIT
  if (probe && tid == 0) {
    ck[7] = clock64() - k_start;
    for (int k = 0; k < 8; ++k)
      if (k != 3 && k != 4) split_clu[k] = ck[k];
  }
  if (probe && tid == 64) {
    split_clu[3] = ck[3];
    split_clu[4] = ck[4];
  }
#endif
}

template <typename T, class Link>
__global__ void __launch_bounds__(CLUSTER_THREADS)
    small_eigh_cluster_kernel(const T* __restrict__ A_in, T* __restrict__ w_out,
                              T* __restrict__ V_out, int* __restrict__ info, int n,
                              int max_sweeps, Link link, R* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R red[32];
  __shared__ int ctl;
  Link L = link;
  L.begin(&ctl);
  Part P;
  P.np = n + (n & 1);
  P.h = P.np / 2;
  P.m = P.np - 1;
  P.ld = P.np + 1;
  P.S = (P.h + L.parts() - 1) / L.parts();
  P.s0 = min(L.rank * P.S, P.h);
  P.s1 = min(P.h, P.s0 + P.S);
  P.Sc = P.s1 - P.s0;
  P.TAB = 7 * P.h + (P.h & 1);  // doubles of one parity's table (even)
  P.BUF = (size_t)2 * P.S * P.ld;
  P.rows = reinterpret_cast<R*>(smem_raw);
  P.tab = P.rows + 2 * P.BUF;
  P.dst = reinterpret_cast<unsigned*>(P.tab + 2 * P.TAB);
  for (int b = L.first(); b < L.last(); ++b) {
    jacobi_rounds(L, P, A_in + (size_t)b * n * n, w_out + (size_t)b * n,
                  V_out + (size_t)b * n * n, info + b, n, max_sweeps,
                  work + (size_t)b * cluster_work_doubles(n, max_sweeps), red,
                  b == 0 && L.rank == 0);
    __syncthreads();  // the shared memory is the next matrix's
  }
}

// (2) V from the rotation log: a warp per row k of V (the grid: batch ×
// ⌈n / VEC_ROWS⌉ CTAs), lane l holding the row's entries at the slots
// j = RR·l … RR·l + RR − 1 by side, va (the index a_j) and vb (b_j), from
// V = I. A round applies `rotate_v` to (V[k][p], V[k][q]) of each slot
// (a is the slot's q exactly when 1 ≤ j ≤ min(rd, m − 1 − rd)), then moves
// every entry with its index: a down a slot, b up a slot, two shuffles.
// After the rounds (whole sweeps), every index is back at its round-0
// position, where V is written out in index order. The log comes through
// shared memory `vr` rounds at a time (VEC_ROUNDS, fewer where 2·vr·h·16 B
// would pass VEC_SMEM), the next chunk copied (cp.async) while this one is
// applied; to VEC_AHEAD_R slots a lane each round's (c, s) is loaded a
// round ahead, past it (the grid's n) when it is applied. Any RR ≥ ⌈h/32⌉
// gives the same bits. The probe's build sums, for matrix 0's first CTA,
// [8] the kernel's cycles and [9] its waits for the log.
template <int RR>
__global__ void __launch_bounds__(VEC_THREADS)
    small_eigh_vectors_kernel(int n, int max_sweeps, R* __restrict__ work, int blocks,
                              int vr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double2* stage = reinterpret_cast<double2*>(smem_raw);  // [2][vr][h]
  constexpr bool AHEAD = RR <= VEC_AHEAD_R;
  const int np = n + (n & 1), h = np / 2, m = np - 1;
  const int b = blockIdx.x / blocks, blk = blockIdx.x - b * blocks;
  R* ws = work + (size_t)b * cluster_work_doubles(n, max_sweeps);
  const double2* rlog = reinterpret_cast<const double2*>(ws);
  R* Vg = ws + 2 * ((size_t)max_sweeps * m + 1) * h;
  const int* status = reinterpret_cast<const int*>(Vg + 2 * (size_t)np * np);
  if (status[0] == NONFINITE) return;
  const int rounds = status[1];
  const int tid = threadIdx.x, lane = tid & 31;
  const int k = blk * VEC_ROWS + (tid >> 5);
  const bool live = k < n;
#ifdef SMALL_EIGH_SPLIT
  const long long k_start = clock64();
  long long stage_clk = 0;
#endif
  R va[RR], vb[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int j = lane * RR + r;
    va[r] = j < h && k == j ? R(1) : R(0);
    vb[r] = j < h && k == (j == 0 ? m : m - j) ? R(1) : R(0);
  }
  const int chunk = vr * h;
  auto fetch = [&](int g0, int buf) {
    const int cnt = min(vr, rounds - g0);
    for (int e = tid; e < cnt * h; e += VEC_THREADS)
      __pipeline_memcpy_async(stage + buf * chunk + e, rlog + (size_t)g0 * h + e,
                              sizeof(double2));
    __pipeline_commit();
  };
  if (rounds > 0) fetch(0, 0);
  int rd = 0;
  for (int g0 = 0, buf = 0; g0 < rounds; g0 += vr, buf ^= 1) {
    const int cnt = min(vr, rounds - g0);
    const bool more = g0 + vr < rounds;
    if (more) fetch(g0 + vr, buf ^ 1);
#ifdef SMALL_EIGH_SPLIT
    const long long s_0 = clock64();
#endif
    if (more)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
#ifdef SMALL_EIGH_SPLIT
    stage_clk += clock64() - s_0;
#endif
    // each round's (c, s), loaded a round ahead (AHEAD), off the rotations'
    // chain
    double2 xs[AHEAD ? RR : 1];
    if constexpr (AHEAD) {
#pragma unroll
      for (int r = 0; r < RR; ++r) xs[r] = stage[buf * chunk + min(lane * RR + r, h - 1)];
    }
    for (int q = 0; live && q < cnt; ++q) {
      double2 nx[AHEAD ? RR : 1];
      if constexpr (AHEAD) {
        const double2* nc = stage + buf * chunk + min(q + 1, cnt - 1) * h;
#pragma unroll
        for (int r = 0; r < RR; ++r) nx[r] = nc[min(lane * RR + r, h - 1)];
      }
      const double2* cs = stage + buf * chunk + q * h;
      const int top = min(rd, m - 1 - rd);
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int j = lane * RR + r;
        double2 x;
        if constexpr (AHEAD)
          x = xs[r];
        else
          x = cs[min(j, h - 1)];
        const bool aq = j >= 1 && j <= top;  // the slot's a is its q
        const R vp = aq ? vb[r] : va[r], vq = aq ? va[r] : vb[r];
        R np_, nq_;
        rotate_v_rn(x.x, x.y, vp, vq, np_, nq_);
        va[r] = aq ? nq_ : np_;
        vb[r] = aq ? np_ : nq_;
      }
      const R a0 = __shfl_sync(FULL, va[0], 0);
      const R right = __shfl_down_sync(FULL, va[0], 1);
      const R left = __shfl_up_sync(FULL, vb[RR - 1], 1);
      R na[RR], nb[RR];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int j = lane * RR + r;
        na[r] = j == h - 1 ? vb[r] : (r + 1 < RR ? va[r + 1] : right);
        nb[r] = j == 0 ? vb[r] : (j == 1 ? a0 : (r > 0 ? vb[r - 1] : left));
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        va[r] = na[r];
        vb[r] = nb[r];
      }
      if constexpr (AHEAD) {
#pragma unroll
        for (int r = 0; r < RR; ++r) xs[r] = nx[r];
      }
      rd = rd + 1 == m ? 0 : rd + 1;
    }
    __syncthreads();  // the chunk is read before the next fetch overwrites it
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int j = lane * RR + r;
      if (j < h) {
        Vg[(size_t)k * np + j] = va[r];
        Vg[(size_t)k * np + (j == 0 ? m : m - j)] = vb[r];
      }
    }
  }
#ifdef SMALL_EIGH_SPLIT
  if (b == 0 && blk == 0 && tid == 0) {
    split_clu[8] = clock64() - k_start;
    split_clu[9] = stage_clk;
  }
#endif
}

// (3) the eigenvalues ranked and the eigenvectors signed (`write_sorted`),
// ⌈n/32⌉ CTAs per matrix (`blocks`), each ranking all n and signing 32
// columns, a warp each, the diagonal and the ranking in dynamic shared
// memory (12·n bytes); the probe's build stamps [10] the kernel's cycles
constexpr int SORT_THREADS = 1024;
template <typename T>
__global__ void __launch_bounds__(SORT_THREADS)
    small_eigh_sort_kernel(T* __restrict__ w_out, T* __restrict__ V_out,
                           int* __restrict__ info, int n, int max_sweeps,
                           R* __restrict__ work, int blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* diag = reinterpret_cast<R*>(smem_raw);  // (n)
  int* perm = reinterpret_cast<int*>(diag + n);  // (n)
#ifdef SMALL_EIGH_SPLIT
  const long long k_start = clock64();
#endif
  const int np = n + (n & 1), h = np / 2, m = np - 1;
  const int b = blockIdx.x / blocks, blk = blockIdx.x - b * blocks;
  const R* ws = work + (size_t)b * cluster_work_doubles(n, max_sweeps);
  const R* Vg = ws + 2 * ((size_t)max_sweeps * m + 1) * h;
  const R* Ad = Vg + (size_t)np * np;
  const int* status = reinterpret_cast<const int*>(Ad + (size_t)np * np);
  if (status[0] == NONFINITE) return;
  constexpr int WARPS = SORT_THREADS / 32;
  write_sorted(Ad, Vg, np, n, diag, perm, w_out + (size_t)b * n,
               V_out + (size_t)b * n * n, threadIdx.x, SORT_THREADS, blk * WARPS,
               blocks * WARPS, blk == 0);
  if (blk == 0 && threadIdx.x == 0) info[b] = status[0];
#ifdef SMALL_EIGH_SPLIT
  if (b == 0 && blk == 0 && threadIdx.x == 0) split_clu[10] = clock64() - k_start;
#endif
}

template <int RR>
int launch_vectors(int batch, int n, int max_sweeps, R* work, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    // the most staging any n needs; set once, outside any capture
    const cudaError_t e = cudaFuncSetAttribute(
        small_eigh_vectors_kernel<RR>, cudaFuncAttributeMaxDynamicSharedMemorySize, VEC_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int h = (n + (n & 1)) / 2, blocks = (n + VEC_ROWS - 1) / VEC_ROWS;
  const int fit = VEC_SMEM / (2 * h * (int)sizeof(double2));
  const int vr = fit < VEC_ROUNDS ? fit : VEC_ROUNDS;
  small_eigh_vectors_kernel<RR>
      <<<batch * blocks, VEC_THREADS, 2 * vr * h * sizeof(double2), st>>>(
          n, max_sweeps, work, blocks, vr);
  return (int)cudaGetLastError();
}

// the vectors kernel with RR = ⌈h / 32⌉ slots a lane
template <int RR>
int launch_vectors_for(int rr, int batch, int n, int max_sweeps, R* work, cudaStream_t st) {
  if constexpr (RR > VEC_MAX_R) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (rr == RR) return launch_vectors<RR>(batch, n, max_sweeps, work, st);
    return launch_vectors_for<RR + 1>(rr, batch, n, max_sweeps, work, st);
  }
}

// (3), its shared memory sized at launch (the attribute set once, for the
// largest)
template <typename T>
int launch_sort(void* w, void* V, void* info, int batch, int n, int max_sweeps, R* work,
                cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_eigh_sort_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, VEC_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = (size_t)n * (sizeof(R) + sizeof(int));
  if (smem > (size_t)VEC_SMEM) return (int)cudaErrorInvalidValue;
  const int blocks = (n + SORT_THREADS / 32 - 1) / (SORT_THREADS / 32);
  small_eigh_sort_kernel<T><<<batch * blocks, SORT_THREADS, smem, st>>>(
      (T*)w, (T*)V, (int*)info, n, max_sweeps, work, blocks);
  return (int)cudaGetLastError();
}

// (2) and (3) after the rounds
template <typename T>
int launch_tail(void* w, void* V, void* info, int batch, int n, int max_sweeps, R* work,
                cudaStream_t st) {
  const int err = launch_vectors_for<1>((n + (n & 1) + 63) / 64, batch, n, max_sweeps,
                                        work, st);
  if (err) return err;
  return launch_sort<T>(w, V, info, batch, n, max_sweeps, work, st);
}

template <typename T>
int launch_cluster(const void* A, void* w, void* V, void* info, int batch, int n,
                   int max_sweeps, void* work, void* stream) {
  const int C = cluster_size(n);
  if (n < 3 || n > CLUSTER_MAX_N || batch < 1 || max_sweeps < 0 || C == 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel = small_eigh_cluster_kernel<T, ClusterLink>;
  const cudaStream_t st = (cudaStream_t)stream;
  static bool attr_set = false;
  if (!attr_set) {
    // once, outside any capture: the largest shared memory, clusters past
    // the portable 8, and one cluster of CLUSTER_MAX_C CTAs at that shared
    // memory fits on the card
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CLUSTER_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER_MAX_C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER_MAX_C, 1, 1);
    cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
    cfg.dynamicSmemBytes = CLUSTER_SMEM;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int fit = 0;
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
    attr_set = true;
  }
  const size_t smem = (size_t)cluster_smem_doubles(n, C) * sizeof(double);
  ClusterLink link = {};
  link.C = C;
  cudaError_t e;
  if (C == 1) {
    kernel<<<batch, CLUSTER_THREADS, smem, st>>>((const T*)A, (T*)w, (T*)V, (int*)info, n,
                                                  max_sweeps, link, (R*)work);
    e = cudaGetLastError();
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * C, 1, 1);
    cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps,
                           link, (R*)work);
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  return launch_tail<T>(w, V, info, batch, n, max_sweeps, (R*)work, st);
}

// The grid route: G = grid_size(n) CTAs of a cooperative launch
// (cudaLaunchKernelEx with the cooperative attribute, which a CUDA graph
// capture takes), refused when the card does not hold them all at once.
// `work`: batch × cluster_work_doubles(n, max_sweeps) and then
// grid_extra_doubles(n, G); the barrier's count is zeroed on the stream
// first.
template <typename T>
int launch_grid(const void* A, void* w, void* V, void* info, int batch, int n,
                int max_sweeps, void* work, void* stream) {
  const int G = grid_size(n);
  if (n < 3 || batch < 1 || max_sweeps < 0 || G == 0) return (int)cudaErrorInvalidValue;
  const auto kernel = small_eigh_cluster_kernel<T, GridLink>;
  const cudaStream_t st = (cudaStream_t)stream;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CLUSTER_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = (size_t)cluster_smem_doubles(n, G) * sizeof(double);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CLUSTER_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t np = n + (n & 1), h = np / 2;
  R* extra = (R*)work + (size_t)batch * cluster_work_doubles(n, max_sweeps);
  GridLink link = {};
  link.G = G;
  link.batch = batch;
  link.gtab = extra;
  link.mail = extra + 2 * (7 * h + (h & 1));
  link.count = reinterpret_cast<unsigned*>(link.mail + 4 * (size_t)G * np);
  link.flag = reinterpret_cast<int*>(link.count + 1);
  e = cudaMemsetAsync(link.count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps,
                         link, (R*)work);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_tail<T>(w, V, info, batch, n, max_sweeps, (R*)work, st);
}

// ---------------------------------------------------------------------------
// the stream route (small_eigh_stream: n > GRID_MAX_N; any n ≥ STREAM_MIN_N
// where forced)

// the smallest n: at two pairs the two look-ahead lanes of one CTA would
// update the same block
constexpr int STREAM_MIN_N = 5;
// the stream kernel's threads a CTA, and the items (a slot's rows at 32
// column slots) an update warp loads before it stores: 512 threads and 6
// items were the fastest of the counts timed in turns on the H100 at n =
// 1062 and 2112, by 19-33 % at 2112 over 1024 threads, which cap a thread
// at 64 registers (PERF.md §6)
constexpr int STREAM_THREADS = 512;
constexpr int STREAM_SB = 6;
// the vectors kernel with V's rows in shared memory: rows (a warp each) a
// CTA, at most, and the fewest entries of the log it stages at once
constexpr int VS_MAX_ROWS = 8;
constexpr int VS_MIN_CHUNK = 32;

#ifdef SMALL_EIGH_SPLIT
// the probe's build: matrix 0's clock64() cycles on CTA 0 in the stream
// route, as `stream_rounds` says
__device__ long long split_str[8];
#endif

// the CTAs of the stream route at n: the most with ≥ 2 pairs each, at most
// GRID_MAX_G (the smallest S whose ⌈h/S⌉ CTAs the card holds; 0 below
// STREAM_MIN_N). Every CTA holds a slot; the last may hold one
__host__ __device__ constexpr int stream_size(int n) {
  if (n < STREAM_MIN_N) return 0;
  const int h = (n + (n & 1)) / 2;
  for (int S = 2; S <= h; ++S) {
    const int G = (h + S - 1) / S;
    if (G <= GRID_MAX_G) return G;
  }
  return 0;
}

// bytes of the stream kernel's dynamic shared memory at n on G CTAs: a
// round's table, (c, s) and the pair of every slot (2h doubles and h ints,
// rounded up to even), t and the three entries of the CTA's slots and its
// neighbours' (4 × (S + 2) doubles), and the look-ahead's two blocks per slot
// (2·S ints)
__host__ __device__ constexpr size_t stream_smem_bytes(int n, int G) {
  const size_t h = (n + (n & 1)) / 2, S = (h + G - 1) / G;
  return 16 * h + 4 * (h + (h & 1)) + 32 * (S + 2) + 8 * S;
}

// whether the stream route takes n: its CTAs hold the round table in shared
// memory, the vectors kernel one row of V and two chunks of the log, and
// the sort kernel the diagonal and the ranking (12·n B, which binds first)
__host__ __device__ constexpr bool stream_fits(int n) {
  const int G = stream_size(n);
  const size_t np = n + (n & 1);
  return G > 0 && stream_smem_bytes(n, G) <= (size_t)CLUSTER_SMEM &&
         np * sizeof(double) + 2 * VS_MIN_CHUNK * 16 <= (size_t)VEC_SMEM &&
         (size_t)n * (sizeof(double) + sizeof(int)) <= (size_t)VEC_SMEM;
}

// the stream route's largest n. The card's memory runs out before it: the
// rotation log alone is 240·n² B at the package's 30 sweeps, ~90 GB at this n. The
// pairs packed as p | q << 16 need n ≤ 32768
constexpr int STREAM_MAX_N = 19370;
static_assert(stream_fits(STREAM_MAX_N) && !stream_fits(STREAM_MAX_N + 1) &&
                  STREAM_MAX_N <= 32768,
              "STREAM_MAX_N is the largest n the stream route takes");

// doubles the stream route adds after its matrices' workspaces (each the
// cluster family's: the log, V, A by index, two ints), shared by them: the
// global round table (two parities of 7h, as the grid's), the stop test's
// partial sums (two buffers × 64) and the barrier's count
__host__ __device__ inline size_t stream_extra_doubles(int n) {
  const size_t h = (n + (n & 1)) / 2;
  const size_t total = 2 * (7 * h + (h & 1)) + 128 + 1;
  return total + (total & 1);
}

// The stream route's CTAs: the grid's counter barrier and global round
// table (GridLink), and the stop test's partial sums
struct StreamLink : GridLink {
  R* part;  // [2][64]: per buffer the off-diagonal sums, then the full ones
};

// One CTA's part of a matrix in the stream route: its slots [s0, s1), the
// neighbourhood [lo, lo + w) whose t and entries it imports, its copy of a
// round's table (cs, pq, loc: t, dp, dq, apq by slot − lo) and, per own slot,
// the column slots whose block its look-ahead lane updates (skip, −1: none)
struct StreamPart {
  int np, h, m, S, s0, s1, Sc, lo, w, TAB;
  double2* cs;
  int* pq;
  R* loc;
  int* skip;
  __device__ TabView view() const {
    return TabView{cs, pq, loc - lo, loc + w - lo, loc + 2 * w - lo, loc + 3 * w - lo};
  }
  // the table of parity `par` from the global one into this CTA's shared
  // memory: (c, s) and the pairs of every slot, t and the entries of slots
  // lo … lo + w − 1. Its e-th double: from src[o] to *to
  __device__ __forceinline__ void import_at(int e, int& o, R*& to) const {
    const int hp = (h + 1) / 2;
    if (e < 2 * h) {
      o = e;
      to = reinterpret_cast<R*>(cs) + e;
    } else if (e < 2 * h + hp) {
      o = 6 * h + e - 2 * h;
      to = reinterpret_cast<R*>(pq) + e - 2 * h;
    } else {
      const int x = e - 2 * h - hp, q = x / w;
      o = (2 + q) * h + lo + x - q * w;
      to = loc + x;
    }
  }
  __device__ __forceinline__ int import_size() const { return 2 * h + (h + 1) / 2 + 4 * w; }
  // a thread's first K doubles of the import, loaded (before the round's
  // loads of A, so that they come back first) ...
  template <int K>
  __device__ __forceinline__ void import_load(const R* gtab, int par, R (&v)[K]) const {
    const int total = import_size();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      int o;
      R* to;
      if (e < total) {
        import_at(e, o, to);
        v[k] = __ldcg(gtab + par * TAB + o);
      }
    }
  }
  // ... then stored, and the rest (past K a thread) loaded and stored, the
  // loads of a pass before its stores
  template <int K>
  __device__ __forceinline__ void import_store(const R* gtab, int par, const R (&v)[K]) const {
    const int total = import_size();
    const int nt = blockDim.x;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = threadIdx.x + k * nt;
      int o;
      R* to;
      if (e < total) {
        import_at(e, o, to);
        *to = v[k];
      }
    }
    for (int e0 = threadIdx.x + K * nt; e0 < total; e0 += K * nt) {
      R u[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = e0 + k * nt;
        int o;
        R* to;
        if (e < total) {
          import_at(e, o, to);
          u[k] = __ldcg(gtab + par * TAB + o);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = e0 + k * nt;
        int o;
        R* to;
        if (e < total) {
          import_at(e, o, to);
          *to = u[k];
        }
      }
    }
  }
  __device__ void import(const R* gtab, int par) const {
    R v[GridLink::IMPORT];
    import_load(gtab, par, v);
    import_store(gtab, par, v);
  }
};

// The one-CTA kernel's strided sums of A's squared entries (A by index in
// global memory, read from L2) for its thread t of nt: e = t, t + nt, … in
// order, the diagonal an exact 0 in `off`, every entry in `all` (BOTH);
// the loads of eight terms before their sums
template <bool BOTH>
__device__ void stream_strided(const R* A, int np, int nt, int t, R& off, R& all) {
  const int size = np * np, du = nt / np, dv = nt - du * np;
  int u = t / np, v = t - u * np;
  off = R(0);
  all = R(0);
  for (int e0 = t; e0 < size; e0 += 8 * nt) {
    R a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * nt;
      a[k] = e < size ? __ldcg(A + e) : R(0);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (e0 + k * nt < size) {
        const R x = u == v ? R(0) : a[k];
        off += x * x;
        if (BOTH) all += a[k] * a[k];
        u += du;
        v += dv;
        if (v >= np) {
          v -= np;
          ++u;
        }
      }
    }
  }
}

// This CTA's share of the stop test: the one-CTA kernel's virtual warps v ≡
// rank (mod G) of its nt threads, a warp each, lane l playing thread 32v + l:
// its strided sums, the warp's __shfl_down tree, into part[v] (and, BOTH,
// the sum with the diagonal into part[32 + v]); the tree over the warps'
// sums is `stream_total`'s, after the barrier
template <bool BOTH>
__device__ void stream_partials(const R* A, int np, int nt, R* part, int rank, int G) {
  const int lane = threadIdx.x & 31, nw = nt >> 5;
  for (int v = rank + G * (int)(threadIdx.x >> 5); v < nw; v += G * (int)(blockDim.x >> 5)) {
    R off, all;
    stream_strided<BOTH>(A, np, nt, 32 * v + lane, off, all);
    for (int o = 16; o > 0; o >>= 1) {
      off += __shfl_down_sync(FULL, off, o);
      if (BOTH) all += __shfl_down_sync(FULL, all, o);
    }
    if (lane == 0) {
      part[v] = off;
      if (BOTH) part[32 + v] = all;
    }
  }
}

// the tree over the nw warps' sums at `part` (a warp's; every lane returns
// it), as the one-CTA kernel's block_sum takes it
__device__ __forceinline__ R stream_total(const R* part, int nw) {
  const int lane = threadIdx.x & 31;
  R x = lane < nw ? __ldcg(part + lane) : R(0);
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
  return __shfl_sync(FULL, x, 0);
}

// An update warp's STREAM_SB items of a round (item (il, jp): slot s0 +
// il's rows at column slots 32·jp … 32·jp + 31, a lane each): per item the
// slot's pair, the column slot's (0: the slot's own, −1: nothing to do), i
// | j << 16, and the block's four entries, loaded before any is stored
struct StreamBatch {
  R x[STREAM_SB][4];
  int pqi[STREAM_SB], pqj[STREAM_SB], ij[STREAM_SB];

  // the look-ahead's block for next round's slot k into item 0: pqi the
  // pair of k's source slot on this CTA (L), pqj the other's (O)
  __device__ __forceinline__ void load_ahead(int k, int rd, const StreamPart& P, const R* Ad) {
    const AheadSrc src = ahead_src(k, rd, P.h, P.m, P.s0, P.s1);
    int p, q;
    pair_fast(rd, src.L, P.np, p, q);
    pqi[0] = p | (q << 16);
    const R* rp = Ad + (size_t)p * P.np;
    const R* rq = Ad + (size_t)q * P.np;
    pair_fast(rd, src.O, P.np, p, q);
    pqj[0] = p | (q << 16);
    x[0][0] = __ldcg(rp + p);
    x[0][1] = __ldcg(rp + q);
    x[0][2] = __ldcg(rq + p);
    x[0][3] = __ldcg(rq + q);
  }

  // the pairs from the round (not the table), so that the loads may be in
  // flight while the table comes in
  __device__ __forceinline__ void load(int it0, int rd, int items, int NJ, int nuw, int lane,
                                       const StreamPart& P, const R* Ad) {
#pragma unroll
    for (int k = 0; k < STREAM_SB; ++k) {
      const int item = it0 + k * nuw;
      pqj[k] = -1;
      if (item >= items) continue;
      const int il = item / NJ, i = P.s0 + il, j = 32 * (item - il * NJ) + lane;
      if (j >= P.h || j == P.skip[2 * il] || j == P.skip[2 * il + 1]) continue;
      int p, q;
      pair_fast(rd, i, P.np, p, q);
      pqi[k] = p | (q << 16);
      ij[k] = i | (j << 16);
      if (j == i) {
        pqj[k] = 0;
        continue;
      }
      const R* rp = Ad + (size_t)p * P.np;
      const R* rq = Ad + (size_t)q * P.np;
      pair_fast(rd, j, P.np, p, q);
      pqj[k] = p | (q << 16);
      x[k][0] = __ldcg(rp + p);
      x[k][1] = __ldcg(rp + q);
      x[k][2] = __ldcg(rq + p);
      x[k][3] = __ldcg(rq + q);
    }
  }

  __device__ __forceinline__ void store(const StreamPart& P, const TabView& tb, R* Ad) const {
#pragma unroll
    for (int k = 0; k < STREAM_SB; ++k) {
      if (pqj[k] < 0) continue;
      R* rp = Ad + (size_t)(pqi[k] & 0xffff) * P.np;
      R* rq = Ad + (size_t)(pqi[k] >> 16) * P.np;
      if (pqj[k] == 0) {
        __stcg(rp + (pqi[k] >> 16), R(0));
        __stcg(rq + (pqi[k] & 0xffff), R(0));
        continue;
      }
      const int i = ij[k] & 0xffff, j = ij[k] >> 16;
      const int cp = pqj[k] & 0xffff, cq = pqj[k] >> 16;
      const double2 ci = tb.cs[i], cj = tb.cs[j];
      R pp, pq, qp, qq;
      block_rows_rn(i < j, ci.x, ci.y, cj.x, cj.y, x[k][0], x[k][1], x[k][2], x[k][3], pp, pq,
                    qp, qq);
      __stcg(rp + cp, pp);
      __stcg(rp + cq, pq);
      __stcg(rq + cp, qp);
      __stcg(rq + cq, qq);
    }
  }
};

// Next round's slot k (this CTA's) in the stream route: the look-ahead
// lane updates the block of k's two source slots on the rows of the one on
// this CTA (L) itself, in place (the update warps skip that block), and
// takes the entry between k's indices from it. `StreamBatch::load_ahead`
// loads the block (its item 0) before the table comes in.
__device__ __forceinline__ Ahead stream_ahead(int k, int rd, const StreamPart& P,
                                              const TabView& tb, int pqL, int pqO,
                                              const R* x, R* Ad) {
  const AheadSrc src = ahead_src(k, rd, P.h, P.m, P.s0, P.s1);
  const int pL = pqL & 0xffff, qL = pqL >> 16, pO = pqO & 0xffff, qO = pqO >> 16;
  R* rp = Ad + (size_t)pL * P.np;
  R* rq = Ad + (size_t)qL * P.np;
  const double2 cL = tb.cs[src.L], cO = tb.cs[src.O];
  R pp, pq, qp, qq;
  block_rows_rn(src.L < src.O, cL.x, cL.y, cO.x, cO.y, x[0], x[1], x[2], x[3], pp, pq, qp, qq);
  __stcg(rp + pO, pp);
  __stcg(rp + qO, pq);
  __stcg(rq + pO, qp);
  __stcg(rq + qO, qq);
  const bool top = src.uL == pL;
  return ahead_finish(src, tb, top ? pp : qp, top ? pq : qq);
}

// (1') The rounds on A of one matrix in the stream route, on CTA `rank` of
// G co-resident CTAs: A by index in the workspace (L2), each CTA owning the
// rows of its slots [s0, s1) in every round and rewriting every entry of
// them in place (a slot's two rows at a column slot: 4 loads, `rotate_block`
// as the one-CTA kernel's thread for the block computes it, 4 stores), from
// its own rows alone; a look-ahead lane per slot (warp 0) computes next
// round's table of the CTA's slots (updating the block it reads itself) into
// the global table; one barrier a round. A round starts with its first
// loads of A in flight while the CTA imports the round's table. The stop
// test's sums spread over the CTAs by virtual warp, the tree over them on
// every CTA. The probe's build (SMALL_EIGH_SPLIT) sums, for matrix 0 on CTA
// 0, clock64() cycles into split_str: [0] rounds, [1] warp 0's body (the
// log and the look-ahead) and [2] update warp 1's, both after the import,
// [3] thread 0's barrier (after its own body), [4] the import with the
// first loads in flight, [5] the stop tests and [6] their count, [7] the
// whole call.
template <typename T>
__device__ void stream_rounds(StreamLink& L, const StreamPart& P, const T* __restrict__ Ab,
                              T* __restrict__ w_b, T* __restrict__ V_b,
                              int* __restrict__ info_b, int n, int max_sweeps,
                              R* __restrict__ ws, int& par, int& tests, bool probe) {
  const int np = P.np, h = P.h, m = P.m, s0 = P.s0, Sc = P.Sc, rank = L.rank;
  const int G = L.G, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt_ref = cta_threads(n), nw = nt_ref >> 5;
  double2* rlog = reinterpret_cast<double2*>(ws);
  R* Ad = ws + 2 * ((size_t)max_sweeps * m + 1) * h + (size_t)np * np;
  int* status = reinterpret_cast<int*>(Ad + (size_t)np * np);
  Part gp;  // what GridLink::publish reads
  gp.h = h;
  gp.TAB = P.TAB;
#ifdef SMALL_EIGH_SPLIT
  long long ck[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long k_start = clock64();
#else
  (void)probe;
#endif
  auto in = [&](int u, int v) {
    return u < n && v < n ? R(u >= v ? Ab[u * n + v] : Ab[v * n + u]) : R(0);
  };
  // the CTA's rows at their round-0 positions into A by index (the lower
  // triangle, mirrored), and round 0's rotations of its slots
  for (int e = tid; e < 2 * Sc * np; e += STREAM_THREADS) {
    const int r = e / np, v = e - r * np;
    const int side = r >= Sc, il = side ? r - Sc : r;
    const int u = index_at(0, s0 + il, side, m);
    __stcg(Ad + (size_t)u * np + v, in(u, v));
  }
  for (int il = tid; il < Sc; il += STREAM_THREADS) {
    const int k = s0 + il;
    int p, q;
    pair_fast(0, k, np, p, q);
    Ahead a;
    a.app = in(p, p);
    a.aqq = in(q, q);
    a.apq = in(p, q);
    a.pq = p | (q << 16);
    rotation(a.app, a.aqq, a.apq, a.c, a.s, a.t);
    L.publish(gp, par, k, a);
  }
  L.sync();
  // ‖A‖² and the first stop test
  R* part = L.part + 64 * (tests & 1);
  stream_partials<true>(Ad, np, nt_ref, part, rank, G);
  L.sync();
  ++tests;
  const R norm2 = stream_total(part + 32, nw);
  if (!isfinite(norm2)) {
    if (rank == 0) {
      const R nan = R(0) / R(0);
      for (int e = tid; e < n * n; e += STREAM_THREADS) V_b[e] = T(nan);
      for (int i = tid; i < n; i += STREAM_THREADS) w_b[i] = T(nan);
      if (tid == 0) {
        info_b[0] = 0;
        status[0] = NONFINITE;
      }
    }
    return;
  }
  const R tol2 = EPS * EPS * norm2;
  int verdict = stream_total(part, nw) <= tol2 ? DONE : (max_sweeps == 0 ? CAP : GO);
  const int NJ = (h + 31) / 32, items = Sc * NJ;
  constexpr int NUW = STREAM_THREADS / 32 - 1;
  const TabView tb = P.view();
  int sweeps = 0, g = 0;
  while (verdict == GO) {
    for (int rd = 0; rd < m; ++rd, ++g) {
#ifdef SMALL_EIGH_SPLIT
      const long long t0 = clock64();
#endif
      // the look-ahead's loads, the table's, the update warps' first
      // loads of A, in that order (each comes back about in turn), then the
      // table into shared memory
      StreamBatch bt;
      R tv[GridLink::IMPORT];
      if (warp == 0 && lane < Sc) bt.load_ahead(s0 + lane, rd, P, Ad);
      P.import_load(L.gtab, par, tv);
      if (warp != 0) bt.load(warp - 1, rd, items, NJ, NUW, lane, P, Ad);
      P.import_store(L.gtab, par, tv);
      __syncthreads();
#ifdef SMALL_EIGH_SPLIT
      const long long t1 = clock64();
#endif
      if (warp == 0) {
        // this round's rotations into the log, then next round's table of
        // the CTA's slots, a lane per slot
        for (int il = lane; il < Sc; il += 32) rlog[(size_t)g * h + s0 + il] = tb.cs[s0 + il];
        for (int il = lane; il < Sc; il += 32) {
          if (il >= 32) bt.load_ahead(s0 + il, rd, P, Ad);
          L.publish(gp, par ^ 1, s0 + il,
                    stream_ahead(s0 + il, rd, P, tb, bt.pqi[0], bt.pqj[0], bt.x[0], Ad));
        }
      } else {
        bt.store(P, tb, Ad);
        for (int it0 = warp - 1 + STREAM_SB * NUW; it0 < items; it0 += STREAM_SB * NUW) {
          bt.load(it0, rd, items, NJ, NUW, lane, P, Ad);
          bt.store(P, tb, Ad);
        }
      }
#ifdef SMALL_EIGH_SPLIT
      const long long t2 = clock64();
#endif
      L.sync();
#ifdef SMALL_EIGH_SPLIT
      if (probe && lane == 0 && warp <= 1) {
        const long long t3 = clock64();
        ck[0] += warp == 0;
        ck[warp == 0 ? 1 : 2] += t2 - t1;
        if (warp == 0) {
          ck[3] += t3 - t2;
          ck[4] += t1 - t0;
        }
      }
#endif
      par ^= 1;
    }
    ++sweeps;
#ifdef SMALL_EIGH_SPLIT
    const long long s_0 = clock64();
#endif
    part = L.part + 64 * (tests & 1);
    stream_partials<false>(Ad, np, nt_ref, part, rank, G);
    L.sync();
    ++tests;
    verdict = stream_total(part, nw) <= tol2 ? DONE : (sweeps == max_sweeps ? CAP : GO);
#ifdef SMALL_EIGH_SPLIT
    ck[5] += clock64() - s_0;
    ck[6] += 1;
#endif
  }
  // the diagonal (the table of the next round 0) at each of the CTA's pairs
  P.import(L.gtab, par);
  __syncthreads();
  for (int il = tid; il < Sc; il += STREAM_THREADS) {
    const int k = s0 + il, p = tb.pq[k] & 0xffff, q = tb.pq[k] >> 16;
    __stcg(Ad + (size_t)p * np + p, tb.dp[k]);
    __stcg(Ad + (size_t)q * np + q, tb.dq[k]);
  }
  if (rank == 0 && tid == 0) {
    status[0] = verdict == DONE ? sweeps : -1;
    status[1] = sweeps * m;
  }
#ifdef SMALL_EIGH_SPLIT
  if (probe && tid == 0) {
    ck[7] = clock64() - k_start;
    for (int k = 0; k < 8; ++k)
      if (k != 2) split_str[k] = ck[k];
  }
  if (probe && tid == 32) split_str[2] = ck[2];
#endif
}

template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
    small_eigh_stream_kernel(const T* __restrict__ A_in, T* __restrict__ w_out,
                             T* __restrict__ V_out, int* __restrict__ info, int n,
                             int max_sweeps, StreamLink link, R* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StreamLink L = link;
  L.begin(nullptr);
  StreamPart P;
  P.np = n + (n & 1);
  P.h = P.np / 2;
  P.m = P.np - 1;
  P.S = (P.h + L.G - 1) / L.G;
  P.s0 = min(L.rank * P.S, P.h);
  P.s1 = min(P.h, P.s0 + P.S);
  P.Sc = P.s1 - P.s0;
  P.lo = P.s0 > 0 ? P.s0 - 1 : 0;
  P.w = (P.s1 < P.h ? P.s1 + 1 : P.h) - P.lo;
  P.TAB = 7 * P.h + (P.h & 1);
  P.cs = reinterpret_cast<double2*>(smem_raw);
  P.pq = reinterpret_cast<int*>(P.cs + P.h);
  P.loc = reinterpret_cast<R*>(P.pq + P.h + (P.h & 1));
  P.skip = reinterpret_cast<int*>(P.loc + 4 * (P.S + 2));
  // the blocks the look-ahead lanes update: next slot k's, on the rows of
  // its source slot L here (a slot is the source of at most two)
  if (threadIdx.x == 0) {
    for (int x = 0; x < 2 * P.Sc; ++x) P.skip[x] = -1;
    for (int k = P.s0; k < P.s1; ++k) {
      const AheadSrc src = ahead_src(k, 0, P.h, P.m, P.s0, P.s1);
      const int x = src.L - P.s0;
      P.skip[2 * x + (P.skip[2 * x] >= 0)] = src.O;
    }
  }
  __syncthreads();
  int par = 0, tests = 0;
  for (int b = 0; b < L.batch; ++b) {
    stream_rounds(L, P, A_in + (size_t)b * n * n, w_out + (size_t)b * n,
                  V_out + (size_t)b * n * n, info + b, n, max_sweeps,
                  work + (size_t)b * cluster_work_doubles(n, max_sweeps), par, tests,
                  b == 0 && L.rank == 0);
    // the next matrix's round-0 table goes to the other parity: a CTA may
    // still be copying this one's
    par ^= 1;
    __syncthreads();
  }
}

// (2') V from the rotation log with V's rows in shared memory by index (the
// stream route, any h): a warp per row k of V, `rows` a CTA (the grid:
// batch × ⌈n / rows⌉ CTAs), from V = I; a round applies `rotate_v` to (V[k][p],
// V[k][q]) of each slot, lane l taking slots l, l + 32, … four at a time
// (the pairs of a round are disjoint). The log is staged as in (2), but
// `ce` entries ((c, s) of a slot) at a time, whole rounds or not: a round
// split between two chunks is applied in its two parts in turn (its pairs
// are disjoint, so every entry sees the same operations). The probe's build sums,
// for matrix 0's first CTA, [8] the kernel's cycles and [9] its waits for
// the log.
__global__ void __launch_bounds__(32 * VS_MAX_ROWS)
    small_eigh_vectors_smem_kernel(int n, int max_sweeps, R* __restrict__ work, int blocks,
                                   int ce, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = n + (n & 1), h = np / 2, m = np - 1;
  double2* stage = reinterpret_cast<double2*>(smem_raw);  // [2][ce]
  const int b = blockIdx.x / blocks, blk = blockIdx.x - b * blocks;
  R* ws = work + (size_t)b * cluster_work_doubles(n, max_sweeps);
  const double2* rlog = reinterpret_cast<const double2*>(ws);
  R* Vg = ws + 2 * ((size_t)max_sweeps * m + 1) * h;
  const int* status = reinterpret_cast<const int*>(Vg + 2 * (size_t)np * np);
  if (status[0] == NONFINITE) return;
  const long long total = (long long)status[1] * h;  // the log's entries
  const int tid = threadIdx.x, lane = tid & 31, nthreads = 32 * rows;
  const int k = blk * rows + (tid >> 5);
  const bool live = k < n;
  R* vrow = reinterpret_cast<R*>(stage + 2 * (size_t)ce) + (size_t)(tid >> 5) * np;
#ifdef SMALL_EIGH_SPLIT
  const long long k_start = clock64();
  long long stage_clk = 0;
#endif
  for (int x = lane; x < np; x += 32) vrow[x] = x == k ? R(1) : R(0);
  __syncwarp();
  auto fetch = [&](long long e0, int buf) {
    const int cnt = (int)min((long long)ce, total - e0);
    for (int e = tid; e < cnt; e += nthreads)
      __pipeline_memcpy_async(stage + buf * ce + e, rlog + e0 + e, sizeof(double2));
    __pipeline_commit();
  };
  if (total > 0) fetch(0, 0);
  for (long long e0 = 0, buf = 0; e0 < total; e0 += ce, buf ^= 1) {
    const long long e1 = min(e0 + ce, total);
    const bool more = e1 < total;
    if (more) fetch(e1, buf ^ 1);
#ifdef SMALL_EIGH_SPLIT
    const long long s_0 = clock64();
#endif
    if (more)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
#ifdef SMALL_EIGH_SPLIT
    stage_clk += clock64() - s_0;
#endif
    // the rounds of the chunk, whole or in part: slots [ja, jb) of round g
    for (long long g = e0 / h; live && g * h < e1; ++g) {
      const int rd = (int)(g % m);
      const int ja = (int)(max(e0, g * h) - g * h), jb = (int)(min(e1, g * h + h) - g * h);
      const double2* cs = stage + (buf * ce + g * h - e0);  // at slot 0 of round g
      for (int j0 = ja + lane; j0 < jb; j0 += 4 * 32) {
        int p[4], qq[4];
        R vp[4], vq[4];
        double2 x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = min(j0 + 32 * r, jb - 1);  // past the end: not stored
          pair_fast(rd, j, np, p[r], qq[r]);
          x[r] = cs[j];
          vp[r] = vrow[p[r]];
          vq[r] = vrow[qq[r]];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          R np_, nq_;
          rotate_v_rn(x[r].x, x[r].y, vp[r], vq[r], np_, nq_);
          if (j0 + 32 * r < jb) {
            vrow[p[r]] = np_;
            vrow[qq[r]] = nq_;
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the chunk is read before the next fetch overwrites it
  }
  if (live)
    for (int x = lane; x < np; x += 32) Vg[(size_t)k * np + x] = vrow[x];
#ifdef SMALL_EIGH_SPLIT
  if (b == 0 && blk == 0 && tid == 0) {
    split_clu[8] = clock64() - k_start;
    split_clu[9] = stage_clk;
  }
#endif
}

// (2') for `batch` matrices: the most rows a CTA (to VS_MAX_ROWS) whose
// shared memory also holds two rounds of the log (one row past n ≈ 9 680,
// where two rounds no longer fit beside it), and chunks of the log as
// large as fit beside them (to VEC_ROUNDS rounds, at least VS_MIN_CHUNK
// entries), whole rounds or not
int launch_vectors_smem(int batch, int n, int max_sweeps, R* work, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_eigh_vectors_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VEC_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t np = n + (n & 1), h = np / 2, entry = sizeof(double2);
  int rows = VS_MAX_ROWS;
  while (rows > 1 && rows * np * sizeof(R) + 2 * h * entry > (size_t)VEC_SMEM) --rows;
  if (rows * np * sizeof(R) + 2 * VS_MIN_CHUNK * entry > (size_t)VEC_SMEM)
    return (int)cudaErrorInvalidValue;
  size_t ce = (VEC_SMEM - rows * np * sizeof(R)) / (2 * entry);
  if (ce > VEC_ROUNDS * h) ce = VEC_ROUNDS * h;
  const int blocks = (n + rows - 1) / rows;
  small_eigh_vectors_smem_kernel<<<batch * blocks, 32 * rows,
                                   2 * ce * entry + rows * np * sizeof(R), st>>>(
      n, max_sweeps, work, blocks, (int)ce, rows);
  return (int)cudaGetLastError();
}

// The stream route: G = stream_size(n) CTAs of a cooperative launch, as the
// grid's (refused when the card does not hold them all at once), then (2')
// and (3). `work`: batch × cluster_work_doubles(n, max_sweeps), then
// stream_extra_doubles(n); the barrier's count is zeroed on the stream
// first.
template <typename T>
int launch_stream(const void* A, void* w, void* V, void* info, int batch, int n,
                  int max_sweeps, void* work, void* stream) {
  const int G = stream_size(n);
  if (batch < 1 || max_sweeps < 0 || !stream_fits(n)) return (int)cudaErrorInvalidValue;
  const auto kernel = small_eigh_stream_kernel<T>;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = stream_smem_bytes(n, G);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CLUSTER_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STREAM_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t h = (n + (n & 1)) / 2;
  R* extra = (R*)work + (size_t)batch * cluster_work_doubles(n, max_sweeps);
  StreamLink link = {};
  link.G = G;
  link.batch = batch;
  link.gtab = extra;
  link.part = extra + 2 * (7 * h + (h & 1));
  link.count = reinterpret_cast<unsigned*>(link.part + 128);
  e = cudaMemsetAsync(link.count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(STREAM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)A, (T*)w, (T*)V, (int*)info, n, max_sweeps,
                         link, (R*)work);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // V: the registers' kernel where a lane holds h (≤ 32·VEC_MAX_R), else
  // the rows in shared memory
  if ((n + (n & 1)) / 2 <= 32 * VEC_MAX_R)
    return launch_tail<T>(w, V, info, batch, n, max_sweeps, (R*)work, st);
  const int err = launch_vectors_smem(batch, n, max_sweeps, (R*)work, st);
  if (err) return err;
  return launch_sort<T>(w, V, info, batch, n, max_sweeps, (R*)work, st);
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

int cora_small_eigh_cluster_f32(const void* A, void* w, void* V, void* info,
                                int batch, int n, int max_sweeps, void* work,
                                void* stream) {
  return launch_cluster<float>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

int cora_small_eigh_cluster_f64(const void* A, void* w, void* V, void* info,
                                int batch, int n, int max_sweeps, void* work,
                                void* stream) {
  return launch_cluster<double>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

// doubles of the cluster family's workspace per matrix of size n
long long cora_small_eigh_cluster_work(int n, int max_sweeps) {
  return (long long)cluster_work_doubles(n, max_sweeps);
}

// the cluster size the family takes at n (0: past CLUSTER_MAX_N)
int cora_small_eigh_cluster_size(int n) { return cluster_size(n); }

int cora_small_eigh_cluster_max_n() { return CLUSTER_MAX_N; }

int cora_small_eigh_grid_f32(const void* A, void* w, void* V, void* info, int batch,
                             int n, int max_sweeps, void* work, void* stream) {
  return launch_grid<float>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

int cora_small_eigh_grid_f64(const void* A, void* w, void* V, void* info, int batch,
                             int n, int max_sweeps, void* work, void* stream) {
  return launch_grid<double>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

// doubles of the grid route's workspace for `batch` matrices of size n
long long cora_small_eigh_grid_work(int n, int max_sweeps, int batch) {
  return (long long)((size_t)batch * cluster_work_doubles(n, max_sweeps) +
                     grid_extra_doubles(n, grid_size(n)));
}

// the CTAs the grid route takes at n (0: none holds it)
int cora_small_eigh_grid_size(int n) { return grid_size(n); }

int cora_small_eigh_grid_max_n() { return GRID_MAX_N; }

int cora_small_eigh_stream_f32(const void* A, void* w, void* V, void* info, int batch,
                               int n, int max_sweeps, void* work, void* stream) {
  return launch_stream<float>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

int cora_small_eigh_stream_f64(const void* A, void* w, void* V, void* info, int batch,
                               int n, int max_sweeps, void* work, void* stream) {
  return launch_stream<double>(A, w, V, info, batch, n, max_sweeps, work, stream);
}

// doubles of the stream route's workspace for `batch` matrices of size n
long long cora_small_eigh_stream_work(int n, int max_sweeps, int batch) {
  return (long long)((size_t)batch * cluster_work_doubles(n, max_sweeps) +
                     stream_extra_doubles(n));
}

// the CTAs the stream route takes at n (0: below STREAM_MIN_N)
int cora_small_eigh_stream_size(int n) { return stream_size(n); }

int cora_small_eigh_stream_max_n() { return STREAM_MAX_N; }

int cora_small_eigh_max_n() { return MAX_N; }

int cora_small_eigh_warp_max_n() { return WARP_N; }

#ifdef SMALL_EIGH_SPLIT
// the split build's cycles of the last one-warp launch (split_clk) into
// the host's out[8]
int cora_small_eigh_split_clocks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, split_clk, sizeof(split_clk));
}

// the split build's cycles of the last cluster-family call (split_clu) into
// the host's out[12]
int cora_small_eigh_cluster_split_clocks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, split_clu, sizeof(split_clu));
}

// the split build's cycles of the last stream call's rounds (split_str)
// into the host's out[8]
int cora_small_eigh_stream_split_clocks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, split_str, sizeof(split_str));
}
#endif

}  // extern "C"
