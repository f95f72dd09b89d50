// Device functions of the TNT hot loop on the canonical (N, r) row-major
// state of a chain graph: Q·Y, tangent projection, Riemannian Hessian-vector
// product, the banded + Woodbury preconditioner solve, the manifold
// projection and a deterministic group reduction.
//
// They replace the `TileOps` math of the JAX package's Pallas kernels
// (cora_tpu/ops/tiles.py: qv :465, dot :550, tangent_project :557,
// hvp :591, precon_solve :647 with _solve_B :750, project_manifold :787).
// Their plain PyTorch versions, with the same names and semantics, are in
// cora_tpu_torch/ops/chain.py; the host plan they read is
// `build_chain_plan` there, and the partition tables `cluster_partition`.
//
// Execution model: every function is called by ALL threads of a group G
// of CTAs, one of two policies:
//   BlockGroup        — one CTA, __syncthreads (the single-CTA
//                       comparators step_block, ladder_block, chunk_block
//                       and tcg_block);
//   ClusterGroup<C>   — a thread-block cluster of C CTAs on C neighbouring
//                       SMs; the group barrier is cluster.sync(), whose
//                       arrive has release and whose wait has acquire
//                       semantics at cluster scope, so global writes before
//                       it are visible to every CTA of the cluster after it.
// CTA c owns a contiguous range of band blocks, their poses, those poses'
// ranges and the state rows of all of them (CTA 0 also the landmark rows);
// the tables come from chain.cluster_partition. Each function writes only
// the rows its CTA owns and ends with a CTA barrier, so its own rows are
// complete for the CTA when it returns; a function that reads rows another
// CTA owns (qv: the neighbouring poses and the landmark rows; each level of
// the doubling scan: block cb ∓ 2^k) first syncs the group, and no pass
// writes a buffer that another CTA may still be reading for the pass
// before it (so Linvᵀ runs in place after the scan). Elementwise
// passes and dot products run over the CTA's own rows; one CTA owns every
// row in canonical order, so BlockGroup indexes the state directly. State,
// scratch and the propagators live in global memory: at the reference
// datasets' sizes one state's working set is a few MB and stays in the
// 50 MB L2; the α-batched ladder's 48 trial points (end of this file) hold
// 39-78 MB of scratch.
//
// What bounds them on an H100 (numbers for the plaza2-shaped graph, r = 4;
// PERF.md): a tCG iteration is a chain of dependent passes over ≤ 56k-element
// vectors, each ended by a group barrier — 2·levels + 5 per iteration (27 at
// 11 scan levels; tnt_kernels.work_counts counts them), 20.5 µs at the
// measured 0.76 µs of a 16-CTA cluster.sync() — and it streams ~22 MB
// through L2, ~20 µs at the 1.07 TB/s that 16 SMs read L2 at; its ~17 MFLOP
// are nothing. One CTA streams those passes through one SM's L2 path
// (92 GB/s); the cluster gives C SMs' L2 paths and keeps the barrier in
// hardware. Measured, a tCG iteration takes 95-132 µs inside a solve: each
// pass waits on its dependent loads for several times its barrier. Staging
// each CTA's propagator slice in shared memory by TMA measured slower
// (PERF.md), so the scan reads the propagators from L2.
// No tensor cores: the products are (w × w)·(w × r) with w ∈ {6, 8} and
// r in the tens (the staircase's ranks), far below a wgmma tile, and TF32
// would change the float32 results.
//
// Reductions are deterministic: fixed thread-to-element assignment, warp
// shuffles and a fixed-order tree within each CTA, then the C partials read
// through distributed shared memory in rank order 0..C−1 by every thread —
// no float atomics — so all CTAs hold bit-identical scalars (their control
// flow cannot diverge, or a cluster barrier would deadlock) and two runs
// from one start give the same trajectory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CORA_NTHREADS 1024
// partial-sum slots per CTA, reused round-robin: a slot is written again
// four publications later, after at least two group barriers past its reads
#define CORA_RING 4

// Host-built constants of one problem (see ChainPlan in ops/chain.py).
// Edge g joins pose g to g+1; the band is the pose-pair blocking of the
// banded factor (block c rows: R_2c (d rows), t_2c, R_2c+1, t_2c+1).
struct ChainPlanArgs {
  int d, n, m, l, N, nb, w, S, levels;
  int parts;            // the partition's CTA count
  const float* kap;     // (n)
  const float* R;       // (n, d, d)
  const float* tau;     // (n)
  const float* tvec;    // (n, d)
  const int* slot;      // (n, S) range index of pose g's slot, -1 empty
  const int* rng_pose;  // (m)
  const int* rng_lm;    // (m)
  const int* lm_ptr;    // (l + 1) ranges of landmark k are
  const int* lm_rng;    // (m)     lm_rng[lm_ptr[k] .. lm_ptr[k+1])
  const float* rr;      // (m) measured distance
  const float* om;      // (m) range precision
  const float* spiv;    // (m) 1 / sphere pivot
  const float* cval;    // (m) omega * r
  const float* Linv;    // (nb, w, w)
  const float* AF;      // (levels, nb, w, w) forward doubling propagators
  const float* Ct;      // (l, nb * w) Woodbury columns, transposed
  const float* BinvCt;  // (l, nb * w)
  const float* capinv;  // (l, l)
  const float* qdwh;    // (8, 3) per-iteration (c, b/c, a - b/c), d = 3
  // partition (chain.ClusterPartition), CTA c of `parts`:
  const int* blk_ptr;   // (parts + 1) band blocks [blk_ptr[c], blk_ptr[c+1])
  const int* row_ptr;   // (parts + 1) rows own_rows[row_ptr[c] .. [c+1])
  const int* own_rows;  // (N) ascending per CTA
  const int* rng_ptr;   // (parts + 1) ranges own_rng[rng_ptr[c] .. [c+1])
  const int* own_rng;   // (m)
  const int* lmc_ptr;   // (parts * l + 1) CTA c's ranges of landmark k:
  const int* lmc_rng;   // (m) lmc_rng[lmc_ptr[c*l+k] .. lmc_ptr[c*l+k+1])
};

// TNT parameters (types.TNTParams), as float32 like the solve.
struct TNTArgs {
  float eta1, eta2, alpha1, alpha2, delta0;
  float grad_tol, pgrad_tol, rel_dec_tol, step_tol, delta_tol;
  float kappa, theta;
};

// ---------------------------------------------------------------------------
// Group policies
// ---------------------------------------------------------------------------
struct BlockGroup {
  static constexpr int kSize = 1;
  __device__ static int rank() { return 0; }
  __device__ static void sync() { __syncthreads(); }
  // `p` (an address in this CTA's shared memory) in CTA `src`'s
  template <class T>
  __device__ static T* at(T* p, int) { return p; }
};

template <int C>
struct ClusterGroup {
  static constexpr int kSize = C;
  __device__ static int rank() { return (int)cg::this_cluster().block_rank(); }
  __device__ static void sync() { cg::this_cluster().sync(); }
  template <class T>
  __device__ static T* at(T* p, int src) {
    return cg::this_cluster().map_shared_rank(p, src);
  }
};

// What one call of the device functions works on: the plan, the rank, the
// scan's scratch, this CTA's share, and the state of the shared-memory
// ring (identical in every thread).
struct Ctx {
  ChainPlanArgs P;
  int r;
  float* band0;  // (nb, w, r) scratch
  float* band1;  // (nb, w, r) scratch
  int rank;      // CTA rank in the group
  int b0, b1;    // own band blocks
  int g0, g1;    // own poses
  float* ring;   // (CORA_RING, W) this CTA's published partials
  int W;         // ring slot width: max(l·r, 1)
  float* lmA;    // (l, r) landmark solution of precon_solve
  float* lmB;    // (l, r) its right-hand side
  int nsum;      // publications so far
};

// The dynamic shared memory of a single-state kernel (step, tcg, chunk,
// ladder_block), in floats: the ring, lmA and lmB, all sized by l·r at
// launch, so the kernels' rank bound is the card's shared memory
// (chain.rank_bound); the reductions read only p < l·r, so the sizing
// changes no arithmetic.
__host__ __device__ inline size_t chain_smem_floats(int l, int r) {
  const int lr = l * r;
  return (size_t)CORA_RING * (lr > 1 ? lr : 1) + 2 * (size_t)lr;
}

// ---------------------------------------------------------------------------
// Reductions
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum
}

// The next slot of this CTA's ring, for a partial that all CTAs read after
// the next group barrier.
__device__ __forceinline__ float* publish_slot(Ctx& c) {
  return c.ring + (c.nsum++ % CORA_RING) * c.W;
}

// Σ over the group's CTAs of slot[p], in rank order (after the barrier that
// follows the slot's publication).
template <class G>
__device__ __forceinline__ float ranked_sum(const float* slot, int p) {
  float acc = *G::at(slot + p, 0);
#pragma unroll
  for (int t = 1; t < G::kSize; ++t) acc += *G::at(slot + p, t);
  return acc;
}

// Sum over the group of one value per thread, returned to every thread:
// the CTA's fixed-order tree, then the CTAs' partials in rank order.
template <class G>
__device__ float group_sum(Ctx& c, float v) {
  __shared__ float part[32];
  float* slot = publish_slot(c);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) part[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? part[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) slot[0] = x;
  }
  G::sync();
  return ranked_sum<G>(slot, 0);
}

// Own element i of the row list, as an index into (N, r) state, and own
// range t of the range list. One part's lists are the identity
// (chain.cluster_partition), so a single CTA skips the tables.
template <class G>
__device__ __forceinline__ int own_elem(const Ctx& c, int i) {
  if constexpr (G::kSize == 1) return i;
  return c.P.own_rows[i / c.r] * c.r + i % c.r;
}

template <class G>
__device__ __forceinline__ int own_rng(const Ctx& c, int t) {
  if constexpr (G::kSize == 1) return t;
  return c.P.own_rng[t];
}

// <A, B> over the group (each CTA its own rows).
template <class G>
__device__ float dot(Ctx& c, const float* A, const float* B) {
  const int a = c.P.row_ptr[c.rank] * c.r, b = c.P.row_ptr[c.rank + 1] * c.r;
  float acc = 0.f;
  for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
    const int x = own_elem<G>(c, i);
    acc += A[x] * B[x];
  }
  return group_sum<G>(c, acc);
}

// The own elements of translation and landmark rows: the tail of the list.
__device__ __forceinline__ void own_tail(const Ctx& c, int D, int& a, int& b) {
  const int nr = c.P.rng_ptr[c.rank + 1] - c.P.rng_ptr[c.rank];
  a = (c.P.row_ptr[c.rank] + (c.g1 - c.g0) * D + nr) * c.r;
  b = c.P.row_ptr[c.rank + 1] * c.r;
}

template <class G>
__device__ __forceinline__ void copy_state(const Ctx& c, const float* src,
                                           float* dst) {
  const int a = c.P.row_ptr[c.rank] * c.r, b = c.P.row_ptr[c.rank + 1] * c.r;
  for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
    const int x = own_elem<G>(c, i);
    dst[x] = src[x];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Per-element bodies of the passes. Each pass below is a loop over its own
// elements calling these; the α-batched passes of the ladder loop over
// (trial point, element) and call the same bodies, so a trial point's
// arithmetic is the single-state pass's, bit for bit.
// ---------------------------------------------------------------------------

// Q·Y's rotation and translation rows of pose g, column j (reference
// CORA_problem.cpp:742-757, factored edge form).
template <int D>
__device__ __forceinline__ void qv_pose(const Ctx& c, const float* Y, int g,
                                        int j, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, nd = n * D, tr0 = nd + P.m, lm0 = tr0 + n;
  const float* Yg = Y + (size_t)g * D * r + j;  // Yg[a * r] = Y[gD+a, j]
  const float tg = Y[(size_t)(tr0 + g) * r + j];
  float acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) acc[a] = 0.f;
  float acc_t = 0.f;
  if (g + 1 < n) {  // outgoing edge g -> g+1
    const float kap = P.kap[g], tau = P.tau[g];
    const float* Rg = P.R + g * D * D;
    const float* tv = P.tvec + g * D;
    const float* Yn = Yg + D * r;
    float u = Y[(size_t)(tr0 + g + 1) * r + j] - tg;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float RYn = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b) RYn += Rg[a * D + b] * Yn[b * r];
      acc[a] += kap * (Yg[a * r] - RYn);
      u -= tv[a] * Yg[a * r];
    }
    const float wv = tau * u;
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a] -= tv[a] * wv;
    acc_t -= wv;
  }
  if (g > 0) {  // incoming edge g-1 -> g
    const float kap = P.kap[g - 1], tau = P.tau[g - 1];
    const float* Rp = P.R + (g - 1) * D * D;
    const float* tv = P.tvec + (g - 1) * D;
    const float* Yp = Yg - D * r;
    float u = tg - Y[(size_t)(tr0 + g - 1) * r + j];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float RtY = 0.f;
#pragma unroll
      for (int b = 0; b < D; ++b) RtY += Rp[b * D + a] * Yp[b * r];
      acc[a] += kap * (Yg[a * r] - RtY);
      u -= tv[a] * Yp[a * r];
    }
    acc_t += tau * u;
  }
  for (int s = 0; s < P.S; ++s) {  // ranges of pose g: v = r y + t_lm - t_g
    const int e = P.slot[g * P.S + s];
    if (e < 0) break;
    const int k = P.rng_lm[e];
    const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                    Y[(size_t)(lm0 + k) * r + j] - tg;
    acc_t -= P.om[e] * v;
  }
#pragma unroll
  for (int a = 0; a < D; ++a) out[(size_t)(g * D + a) * r + j] = acc[a];
  out[(size_t)(tr0 + g) * r + j] = acc_t;
}

// Q·Y's bearing row of range e, column j.
template <int D>
__device__ __forceinline__ void qv_bearing(const Ctx& c, const float* Y, int e,
                                           int j, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D, tr0 = nd + P.m, lm0 = tr0 + P.n;
  const int g = P.rng_pose[e], k = P.rng_lm[e];
  const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                  Y[(size_t)(lm0 + k) * r + j] - Y[(size_t)(tr0 + g) * r + j];
  out[(size_t)(nd + e) * r + j] = P.rr[e] * (P.om[e] * v);
}

// This lane's share of Σ ω·v over this CTA's ranges of landmark k, column
// j (Q·Y's landmark row, before the warp and group sums).
template <int D>
__device__ __forceinline__ float qv_landmark_lane(const Ctx& c, const float* Y,
                                                 int k, int j, int lane) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, l = P.l, nd = P.n * D, tr0 = nd + P.m, lm0 = tr0 + P.n;
  const int t0 = P.lmc_ptr[c.rank * l + k], t1 = P.lmc_ptr[c.rank * l + k + 1];
  float acc = 0.f;
  for (int t = t0 + lane; t < t1; t += 32) {
    const int e = P.lmc_rng[t], g = P.rng_pose[e];
    const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                    Y[(size_t)(lm0 + k) * r + j] -
                    Y[(size_t)(tr0 + g) * r + j];
    acc += P.om[e] * v;
  }
  return acc;
}

// sym(A Bᵀ) of one pose's (D, r) blocks, rows `a * r` apart.
template <int D>
__device__ __forceinline__ void sym_block(const float* A, const float* B,
                                          int r, float S[D][D]) {
  float M[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) M[a][b] = 0.f;
  for (int j = 0; j < r; ++j)
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) M[a][b] += A[a * r + j] * B[b * r + j];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) S[a][b] = 0.5f * (M[a][b] + M[b][a]);
}

// V − sym(Y Vᵀ) Y of one pose's blocks (reference CORA_problem.cpp:782-820);
// O may alias V.
template <int D>
__device__ __forceinline__ void tangent_pose(const float* Yg, const float* Vg,
                                             float* Og, int r) {
  float S[D][D];
  sym_block<D>(Yg, Vg, r, S);
  for (int j = 0; j < r; ++j) {
    float o[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float acc = Vg[a * r + j];
#pragma unroll
      for (int b = 0; b < D; ++b) acc -= S[a][b] * Yg[b * r + j];
      o[a] = acc;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) Og[a * r + j] = o[a];
  }
}

// v − <y, v> y of one bearing row; o may alias v.
__device__ __forceinline__ void tangent_row(const float* y, const float* v,
                                            float* o, int r) {
  float inner = 0.f;
  for (int j = 0; j < r; ++j) inner += y[j] * v[j];
  for (int j = 0; j < r; ++j) o[j] = v[j] - inner * y[j];
}

// The band right-hand side of pose g, column j, into b (rows `stride`
// apart): its rotation rows, its translation + Σ cval·v_s/pivot over its
// ranges; zeros for the padding pose g = n of an odd chain.
template <int D>
__device__ __forceinline__ void band_rhs(const Ctx& c, const float* V, int g,
                                         int j, float* b, int stride) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D, tr0 = nd + P.m;
  if (g < P.n) {
#pragma unroll
    for (int a = 0; a < D; ++a) b[a * stride] = V[(size_t)(g * D + a) * r + j];
    float t = V[(size_t)(tr0 + g) * r + j];
    for (int s = 0; s < P.S; ++s) {
      const int e = P.slot[g * P.S + s];
      if (e < 0) break;
      t += P.cval[e] * (P.spiv[e] * V[(size_t)(nd + e) * r + j]);
    }
    b[D * stride] = t;
  } else {
#pragma unroll
    for (int a = 0; a <= D; ++a) b[a * stride] = 0.f;
  }
}

// This lane's share of Σ cval·v_s/pivot over this CTA's ranges of landmark
// k, column j (the landmark right-hand side).
template <int D>
__device__ __forceinline__ float lm_rhs_lane(const Ctx& c, const float* V,
                                            int k, int j, int lane) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, l = P.l, nd = P.n * D;
  const int t0 = P.lmc_ptr[c.rank * l + k], t1 = P.lmc_ptr[c.rank * l + k + 1];
  float acc = 0.f;
  for (int t = t0 + lane; t < t1; t += 32) {
    const int e = P.lmc_rng[t];
    acc += P.cval[e] * (P.spiv[e] * V[(size_t)(nd + e) * r + j]);
  }
  return acc;
}

// x ← Linvᵀ x for one column of one band block (rows `stride` apart).
template <int D>
__device__ __forceinline__ void linvt_column(const float* L, float* x,
                                             int stride) {
  constexpr int w = 2 * (D + 1);
  float xv[w];
#pragma unroll
  for (int f = 0; f < w; ++f) xv[f] = x[f * stride];
#pragma unroll
  for (int e = 0; e < w; ++e) {
    float acc = 0.f;
#pragma unroll
    for (int f = 0; f < w; ++f) acc += L[f * w + e] * xv[f];
    x[e * stride] = acc;
  }
}

// This lane's share of Σ_t C[t, k] y1[t] over the own band rows, y1's
// rows `stride` apart (the Woodbury product).
__device__ __forceinline__ float wood_lane(const Ctx& c, const float* y1,
                                           int k, int stride, int lane) {
  const float* Ck = c.P.Ct + (size_t)k * c.P.nb * c.P.w;
  float acc = 0.f;
  for (int t = c.b0 * c.P.w + lane; t < c.b1 * c.P.w; t += 32)
    acc += Ck[t] * y1[(size_t)t * stride];
  return acc;
}

// Row k, column j of capinv · lmB (lmB's rows r apart).
__device__ __forceinline__ float capinv_row(const ChainPlanArgs& P,
                                            const float* lmB, int k, int j,
                                            int r) {
  float acc = 0.f;
  for (int kk = 0; kk < P.l; ++kk) acc += P.capinv[k * P.l + kk] * lmB[kk * r + j];
  return acc;
}

// Band row t's value v, column j, corrected by the landmark solution lmA and
// stored to its pose row.
template <int D>
__device__ __forceinline__ void band_to_pose(const Ctx& c, int t, int j,
                                             float v, const float* lmA,
                                             float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, q = D + 1, w = 2 * q, tr0 = P.n * D + P.m;
  const int cb = t / w, e = t % w;
  const int g = 2 * cb + e / q, a = e % q;
  if (g >= P.n) return;
  for (int k = 0; k < P.l; ++k)
    v -= P.BinvCt[(size_t)k * P.nb * w + t] * lmA[k * r + j];
  const int row = a < D ? g * D + a : tr0 + g;
  out[(size_t)row * r + j] = v;
}

// Sphere back-substitution of range e, column j:
// x_s = (v_s − cval (x_lm − x_pose)) / pivot.
template <int D>
__device__ __forceinline__ void sphere_back(const Ctx& c, const float* V,
                                            const float* lmA, int e, int j,
                                            float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D, tr0 = nd + P.m;
  const int g = P.rng_pose[e], k = P.rng_lm[e];
  out[(size_t)(nd + e) * r + j] =
      P.spiv[e] * (V[(size_t)(nd + e) * r + j] -
                   P.cval[e] * (lmA[k * r + j] - out[(size_t)(tr0 + g) * r + j]));
}

// The polar factor of one pose block O (D, r) with Gram matrix G2 = O Oᵀ,
// in place: d=2 closed form with a shift of singular blocks, d=3 QDWH
// (8 iterations, 3×3 Cholesky) (reference CORA_problem.cpp:905-938).
template <int D>
__device__ __forceinline__ void polar_block(const ChainPlanArgs& P, float* Og,
                                            int r, const float G2[D][D]) {
  const float tiny = FLT_MIN;
  if constexpr (D == 2) {
    const float tr0 = G2[0][0] + G2[1][1];
    const float det0 = G2[0][0] * G2[1][1] - G2[0][1] * G2[0][1];
    const float shift = det0 < 1e-6f * fmaxf(tr0 * tr0, tiny) ? 1e-3f * tr0 : 0.f;
    const float G00 = G2[0][0] + shift, G11 = G2[1][1] + shift, G01 = G2[0][1];
    const float t = G00 + G11;
    const float det = G00 * G11 - G01 * G01;
    const float s = sqrtf(fmaxf(det, tiny));
    const float denom = sqrtf(fmaxf(t + 2.f * s, tiny));
    const float dd = fmaxf((G00 + s) * (G11 + s) - G01 * G01, tiny);
    const float cc = denom / dd;
    const float I00 = cc * (G11 + s), I11 = cc * (G00 + s), I01 = -cc * G01;
    for (int j = 0; j < r; ++j) {
      const float a0 = Og[j], a1 = Og[r + j];
      Og[j] = I00 * a0 + I01 * a1;
      Og[r + j] = I01 * a0 + I11 * a1;
    }
  } else {
    float fro2 = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) fro2 += G2[a][a];
    const float sinv = 1.f / sqrtf(fmaxf(fro2, tiny));
    for (int i = 0; i < D * r; ++i) Og[i] *= sinv;
    for (int it = 0; it < 8; ++it) {
      const float cw = P.qdwh[3 * it], bc = P.qdwh[3 * it + 1],
                  abc = P.qdwh[3 * it + 2];
      float W[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) W[a][b] = 0.f;
      for (int j = 0; j < r; ++j)
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = a; b < 3; ++b) W[a][b] += Og[a * r + j] * Og[b * r + j];
      const float z00 = 1.f + cw * W[0][0], z01 = cw * W[0][1],
                  z02 = cw * W[0][2], z11 = 1.f + cw * W[1][1],
                  z12 = cw * W[1][2], z22 = 1.f + cw * W[2][2];
      const float l11 = sqrtf(fmaxf(z00, tiny));
      const float l21 = z01 / l11, l31 = z02 / l11;
      const float l22 = sqrtf(fmaxf(z11 - l21 * l21, tiny));
      const float l32 = (z12 - l31 * l21) / l22;
      const float l33 = sqrtf(fmaxf(z22 - l31 * l31 - l32 * l32, tiny));
      for (int j = 0; j < r; ++j) {
        const float x0 = Og[j], x1 = Og[r + j], x2 = Og[2 * r + j];
        const float y1 = x0 / l11;
        const float y2 = (x1 - l21 * y1) / l22;
        const float y3 = (x2 - l31 * y1 - l32 * y2) / l33;
        const float s3 = y3 / l33;
        const float s2 = (y2 - l32 * s3) / l22;
        const float s1 = (y1 - l21 * s2 - l31 * s3) / l11;
        Og[j] = bc * x0 + abc * s1;
        Og[r + j] = bc * x1 + abc * s2;
        Og[2 * r + j] = bc * x2 + abc * s3;
      }
    }
  }
}

// One bearing row o, holding x with Σ x² = nrm2, scaled to unit length.
__device__ __forceinline__ void unit_row(float* o, int r, float nrm2) {
  const float nrm = fmaxf(sqrtf(nrm2), FLT_MIN);
  for (int j = 0; j < r; ++j) o[j] = o[j] / nrm;
}

// ---------------------------------------------------------------------------
// Q·Y
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void qv(Ctx& c, const float* Y, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, l = P.l, lm0 = P.n * D + P.m + P.n;
  G::sync();  // the neighbouring poses and the landmark rows of Y
  // pose rotation and translation rows: one thread per (own pose, column)
  for (int i = threadIdx.x; i < (c.g1 - c.g0) * r; i += blockDim.x)
    qv_pose<D>(c, Y, c.g0 + i / r, i % r, out);
  // bearing rows of the own ranges
  const int e0 = P.rng_ptr[c.rank], e1 = P.rng_ptr[c.rank + 1];
  for (int i = threadIdx.x; i < (e1 - e0) * r; i += blockDim.x)
    qv_bearing<D>(c, Y, own_rng<G>(c, e0 + i / r), i % r, out);
  // landmark rows: one warp per (landmark, column) sums the own ranges in
  // fixed lane order; the group's partials are summed in rank order
  if (l > 0) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
              nw = blockDim.x >> 5;
    float* slot = publish_slot(c);
    for (int p = wid; p < l * r; p += nw) {
      const float acc = warp_sum(qv_landmark_lane<D>(c, Y, p / r, p % r, lane));
      if (lane == 0) slot[p] = acc;
    }
    G::sync();
    if (c.rank == 0)
      for (int p = threadIdx.x; p < l * r; p += blockDim.x)
        out[(size_t)lm0 * r + p] = ranked_sum<G>(slot, p);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Projection onto T_Y; out may alias V
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void tangent_project(const Ctx& c, const float* Y, const float* V,
                                float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D;
  for (int g = c.g0 + threadIdx.x; g < c.g1; g += blockDim.x) {
    const size_t o = (size_t)g * D * r;
    tangent_pose<D>(Y + o, V + o, out + o, r);
  }
  for (int t = P.rng_ptr[c.rank] + threadIdx.x; t < P.rng_ptr[c.rank + 1];
       t += blockDim.x) {
    const size_t o = (size_t)(nd + own_rng<G>(c, t)) * r;
    tangent_row(Y + o, V + o, out + o, r);
  }
  if (out != V) {
    int a, b;
    own_tail(c, D, a, b);
    for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
      const int x = own_elem<G>(c, i);
      out[x] = V[x];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Riemannian Hessian-vector product (reference CORA_problem.cpp:822-867):
// Proj_TY(Q Ẏ − sym(Y ∇Fᵀ) Ẏ per pose, − <∇F, y> ẏ per bearing row)
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void hvp(Ctx& c, const float* Y, const float* nF, const float* dY,
                    float* out) {
  qv<D, G>(c, dY, out);
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D;
  for (int g = c.g0 + threadIdx.x; g < c.g1; g += blockDim.x) {
    const float* Yg = Y + (size_t)g * D * r;
    const float* Gg = nF + (size_t)g * D * r;
    const float* dg = dY + (size_t)g * D * r;
    float* Hg = out + (size_t)g * D * r;
    float S1[D][D];
    sym_block<D>(Yg, Gg, r, S1);
    for (int j = 0; j < r; ++j) {
      float h[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float acc = Hg[a * r + j];
#pragma unroll
        for (int b = 0; b < D; ++b) acc -= S1[a][b] * dg[b * r + j];
        h[a] = acc;
      }
#pragma unroll
      for (int a = 0; a < D; ++a) Hg[a * r + j] = h[a];
    }
    float S2[D][D];
    sym_block<D>(Yg, Hg, r, S2);
    for (int j = 0; j < r; ++j) {
      float h[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float acc = Hg[a * r + j];
#pragma unroll
        for (int b = 0; b < D; ++b) acc -= S2[a][b] * Yg[b * r + j];
        h[a] = acc;
      }
#pragma unroll
      for (int a = 0; a < D; ++a) Hg[a * r + j] = h[a];
    }
  }
  for (int t = P.rng_ptr[c.rank] + threadIdx.x; t < P.rng_ptr[c.rank + 1];
       t += blockDim.x) {
    const int e = own_rng<G>(c, t);
    const float* y = Y + (size_t)(nd + e) * r;
    const float* gv = nF + (size_t)(nd + e) * r;
    const float* dy = dY + (size_t)(nd + e) * r;
    float* h = out + (size_t)(nd + e) * r;
    float inner = 0.f;
    for (int j = 0; j < r; ++j) inner += gv[j] * y[j];
    for (int j = 0; j < r; ++j) h[j] -= inner * dy[j];
    float inner2 = 0.f;
    for (int j = 0; j < r; ++j) inner2 += y[j] * h[j];
    for (int j = 0; j < r; ++j) h[j] -= inner2 * y[j];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (Q + λI)⁻¹V: sphere elimination → banded doubling scan and its exact
// adjoint → Woodbury landmark correction → sphere back-substitution.
// out must not alias V.
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void precon_solve(Ctx& c, const float* V, float* out) {
  float* lmA = c.lmA;
  float* lmB = c.lmB;
  const ChainPlanArgs& P = c.P;
  const int r = c.r, l = P.l, lm0 = P.n * D + P.m + P.n;
  const int q = D + 1, w = 2 * q, nb = P.nb;
  const int b0 = c.b0, nown = (c.b1 - b0) * w * r, off = b0 * w * r;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  float* src = c.band0;
  float* dst = c.band1;

  // 1) band right-hand side of the own blocks
  for (int i = threadIdx.x; i < 2 * (c.b1 - b0) * r; i += blockDim.x) {
    const int g = 2 * b0 + i / r, j = i % r;
    band_rhs<D>(c, V, g, j, src + (size_t)((g >> 1) * w + (g & 1) * q) * r + j,
                r);
  }
  // landmark right-hand side V_lm − Σ cval·v_s/pivot: this CTA's share of
  // the sum, combined after the Woodbury barrier
  float* rhs = nullptr;
  if (l > 0) {
    rhs = publish_slot(c);
    for (int p = wid; p < l * r; p += nw) {
      const float acc = warp_sum(lm_rhs_lane<D>(c, V, p / r, p % r, lane));
      if (lane == 0) rhs[p] = acc;
    }
  }
  __syncthreads();

  // 2) u = Linv · b, block by block
  for (int i = threadIdx.x; i < nown; i += blockDim.x) {
    const int cb = b0 + i / (w * r), e = (i / r) % w, j = i % r;
    const float* L = P.Linv + (size_t)(cb * w + e) * w;
    const float* b = src + (size_t)cb * w * r + j;
    float acc = 0.f;
    for (int f = 0; f < w; ++f) acc += L[f] * b[f * r];
    dst[off + i] = acc;
  }
  { float* t = src; src = dst; dst = t; }

  // 3) forward doubling levels: u_c += A_k[c] u_{c − 2^k}
  const size_t ww = (size_t)w * w;
  for (int k = 0; k < P.levels; ++k) {
    const int s = 1 << k;
    G::sync();
    const float* A = P.AF + (size_t)k * nb * ww;
    for (int i = threadIdx.x; i < nown; i += blockDim.x) {
      const int cb = b0 + i / (w * r), e = (i / r) % w, j = i % r;
      float v = src[off + i];
      if (cb >= s) {
        const float* Ae = A + (size_t)(cb * w + e) * w;
        const float* u = src + (size_t)(cb - s) * w * r + j;
        for (int f = 0; f < w; ++f) v += Ae[f] * u[f * r];
      }
      dst[off + i] = v;
    }
    { float* t = src; src = dst; dst = t; }
  }
  // 4) the exact adjoint, levels reversed: x_c += A_k[c + 2^k]ᵀ x_{c + 2^k}
  for (int k = P.levels - 1; k >= 0; --k) {
    const int s = 1 << k;
    G::sync();
    const float* A = P.AF + ((size_t)k * nb + s) * ww;  // A_k[cb + 2^k] at cb
    for (int i = threadIdx.x; i < nown; i += blockDim.x) {
      const int cb = b0 + i / (w * r), e = (i / r) % w, j = i % r;
      float v = src[off + i];
      if (cb < nb - s) {
        const float* Ab = A + (size_t)cb * w * w + e;
        const float* x = src + (size_t)(cb + s) * w * r + j;
        for (int f = 0; f < w; ++f) v += Ab[f * w] * x[f * r];
      }
      dst[off + i] = v;
    }
    { float* t = src; src = dst; dst = t; }
  }
  __syncthreads();
  // 5) y1 = Linvᵀ · x in place, one thread per (own block, column): the
  //    other buffer may still be read by a neighbouring CTA's last adjoint
  //    level, and nobody else reads this one now
  for (int i = threadIdx.x; i < nown / w; i += blockDim.x) {
    const int cb = b0 + i / r, j = i % r;
    linvt_column<D>(P.Linv + (size_t)cb * w * w, src + (size_t)cb * w * r + j,
                    r);
  }
  __syncthreads();
  const float* y1 = src;

  // 6) Woodbury landmark correction (every CTA holds the l × r result),
  //    then scatter the own band blocks to pose rows
  if (l > 0) {
    float* wood = publish_slot(c);
    for (int p = wid; p < l * r; p += nw) {
      const float acc = warp_sum(wood_lane(c, y1 + p % r, p / r, r, lane));
      if (lane == 0) wood[p] = acc;
    }
    G::sync();
    for (int p = threadIdx.x; p < l * r; p += blockDim.x) {
      const float a = V[(size_t)lm0 * r + p] - ranked_sum<G>(rhs, p);
      lmB[p] = a - ranked_sum<G>(wood, p);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < l * r; p += blockDim.x) {
      const float acc = capinv_row(P, lmB, p / r, p % r, r);
      lmA[p] = acc;
      if (c.rank == 0) out[(size_t)lm0 * r + p] = acc;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nown; i += blockDim.x)
    band_to_pose<D>(c, b0 * w + i / r, i % r, y1[off + i], lmA, out);
  __syncthreads();

  // 7) sphere back-substitution of the own ranges
  const int e0 = P.rng_ptr[c.rank], e1 = P.rng_ptr[c.rank + 1];
  for (int i = threadIdx.x; i < (e1 - e0) * r; i += blockDim.x)
    sphere_back<D>(c, V, lmA, own_rng<G>(c, e0 + i / r), i % r, out);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Manifold projection of A = Y + scale·V (V may be null): the polar factor
// of each pose block, bearing rows normalised. out must not alias Y or V.
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void retract(const Ctx& c, const float* Y, const float* V,
                        float scale, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D;
  for (int g = c.g0 + threadIdx.x; g < c.g1; g += blockDim.x) {
    const float* Yg = Y + (size_t)g * D * r;
    const float* Vg = V ? V + (size_t)g * D * r : nullptr;
    float* Og = out + (size_t)g * D * r;
    float G2[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) G2[a][b] = 0.f;
    for (int j = 0; j < r; ++j) {
      float x[D];
#pragma unroll
      for (int a = 0; a < D; ++a)
        x[a] = Vg ? Yg[a * r + j] + scale * Vg[a * r + j] : Yg[a * r + j];
#pragma unroll
      for (int a = 0; a < D; ++a) {
#pragma unroll
        for (int b = 0; b < D; ++b) G2[a][b] += x[a] * x[b];
        Og[a * r + j] = x[a];
      }
    }
    polar_block<D>(P, Og, r, G2);
  }
  for (int t = P.rng_ptr[c.rank] + threadIdx.x; t < P.rng_ptr[c.rank + 1];
       t += blockDim.x) {
    const int e = own_rng<G>(c, t);
    const float* y = Y + (size_t)(nd + e) * r;
    const float* v = V ? V + (size_t)(nd + e) * r : nullptr;
    float* o = out + (size_t)(nd + e) * r;
    float nrm2 = 0.f;
    for (int j = 0; j < r; ++j) {
      const float x = v ? y[j] + scale * v[j] : y[j];
      o[j] = x;
      nrm2 += x * x;
    }
    unit_row(o, r, nrm2);
  }
  int a, b;
  own_tail(c, D, a, b);
  for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
    const int x = own_elem<G>(c, i);
    out[x] = V ? Y[x] + scale * V[x] : Y[x];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Composite cores shared by the kernels
// ---------------------------------------------------------------------------
struct StepOut {
  float f, gradnorm, pgradnorm;
};

// Optional retraction of Y along scale·V, then Q·Y, f = ½<Y, QY>, the
// Riemannian gradient, ‖grad‖ and √<grad, P grad> (JAX: _step_core).
// With do_retract == 0, Yn == Y is allowed and the state is evaluated as is.
template <int D, class G>
__device__ StepOut step_core(Ctx& c, const float* Y, const float* V,
                             float scale, int do_retract, float* Yn,
                             float* QY, float* grad, float* pg) {
  if (do_retract)
    retract<D, G>(c, Y, V, scale, Yn);
  else if (Yn != Y)
    copy_state<G>(c, Y, Yn);
  qv<D, G>(c, Yn, QY);
  StepOut o;
  o.f = 0.5f * dot<G>(c, Yn, QY);
  tangent_project<D, G>(c, Yn, QY, grad);
  o.gradnorm = sqrtf(dot<G>(c, grad, grad));
  precon_solve<D, G>(c, grad, pg);
  tangent_project<D, G>(c, Yn, pg, pg);
  const float ip = dot<G>(c, grad, pg);
  o.pgradnorm = ip > 0.f ? sqrtf(fmaxf(ip, 0.f)) : o.gradnorm;
  return o;
}

struct TcgOut {
  float mdec;
  int hit;
  int iters;
  float step_norm;
};

// Steihaug–Toint preconditioned truncated CG with M-norm bookkeeping and
// the superlinear stop rz <= rz0·min(κ, √rz0^θ)² (JAX: _tcg_core).
template <int D, class G>
__device__ TcgOut tcg_core(Ctx& c, const float* g, const float* Y,
                           const float* nF, float delta, int miters,
                           float kappa, float theta, float* s, float* rv,
                           float* dv, float* z, float* Hd) {
  const float tiny = FLT_MIN;
  const int ra = c.P.row_ptr[c.rank] * c.r, rb = c.P.row_ptr[c.rank + 1] * c.r;
  precon_solve<D, G>(c, g, z);
  tangent_project<D, G>(c, Y, z, z);
  const float rz0 = dot<G>(c, g, z);
  // x^θ as exp(θ log x), as the TPU kernel computes it
  const float sq = sqrtf(fmaxf(rz0, 0.f)) + tiny;
  const float mk = fminf(kappa, expf(theta * logf(sq)));
  const float rz_stop = rz0 * (mk * mk);
  for (int i = ra + threadIdx.x; i < rb; i += blockDim.x) {
    const int x = own_elem<G>(c, i);
    s[x] = 0.f;
    rv[x] = g[x];
    dv[x] = -z[x];
  }
  __syncthreads();
  float rz = rz0, phi = 0.f, sigma = 0.f, dmd = rz0, mdec = 0.f;
  int k = 0;
  bool done = rz0 <= 0.f, hit = false;
  while (k < miters && !done) {
    hvp<D, G>(c, Y, nF, dv, Hd);
    const float dHd = dot<G>(c, dv, Hd);
    const float alpha = rz / (dHd == 0.f ? tiny : dHd);
    const float phi_next = phi + 2.f * alpha * sigma + alpha * alpha * dmd;
    const bool crossed = phi_next >= delta * delta;
    const bool negcurv = dHd <= 0.f;
    const bool stop = crossed || negcurv;
    const float disc = fmaxf(sigma * sigma + dmd * (delta * delta - phi), 0.f);
    const float tau = (-sigma + sqrtf(disc)) / (dmd == 0.f ? tiny : dmd);
    const float coef = stop ? tau : alpha;
    mdec = stop ? mdec + tau * rz - 0.5f * tau * tau * dHd
                : mdec + 0.5f * alpha * rz;
    for (int i = ra + threadIdx.x; i < rb; i += blockDim.x) {
      const int x = own_elem<G>(c, i);
      s[x] += coef * dv[x];
      rv[x] += alpha * Hd[x];
    }
    __syncthreads();
    precon_solve<D, G>(c, rv, z);
    tangent_project<D, G>(c, Y, z, z);
    const float rz_new = dot<G>(c, rv, z);
    const bool converged = rz_new <= rz_stop;
    const float beta = rz_new / (rz == 0.f ? tiny : rz);
    for (int i = ra + threadIdx.x; i < rb; i += blockDim.x) {
      const int x = own_elem<G>(c, i);
      dv[x] = -z[x] + beta * dv[x];
    }
    __syncthreads();
    sigma = beta * (sigma + alpha * dmd);
    dmd = rz_new + beta * beta * dmd;
    rz = rz_new;
    if (!stop) phi = phi_next;
    k += 1;
    done = stop || converged;
    hit = hit || stop;
  }
  TcgOut o;
  o.mdec = mdec;
  o.hit = hit ? 1 : 0;
  o.iters = k;
  o.step_norm = sqrtf(dot<G>(c, s, s));
  return o;
}

// ===========================================================================
// The α-batched ladder: step_core's passes for the AB trial points of one
// cluster at once.
//
// Trial point al's three states (retracted Yn, QY — whose rows hold P·grad
// once grad is formed — and grad) are `st` floats apart; the band buffers
// hold (nb, w, Rp), trial point al's columns at al·r .. al·r + r
// (chain.LadderLayout). Each pass loops over (trial point, element) and
// runs the single-state pass's element body; each sum keeps the
// single-state thread-to-element assignment, CTA tree and rank order, with
// ring slots AB·max(l·r, 1) wide. So a trial point's scalars do not depend
// on its batch, and equal the cluster step's at s = α·Ẏ: the retraction
// adds the rounded product α·Ẏ (__fmul_rn keeps it from contracting into
// an FMA), as the host forms s. What the batch saves: the dependent passes,
// and their barriers, are paid once per cluster instead of once per α, and
// each propagator and Linv element is loaded once per four band columns.
// ===========================================================================
struct Batch {
  int AB;       // trial points of this cluster
  int Rp;       // band columns: AB·r rounded up to a multiple of 4
  size_t st;    // floats between two trial points' states
  int W;        // ring slot width: AB·max(l·r, 1)
  float* part;  // (AB, 32) shared: warp partials of the dots
  float* lmA;   // (AB, l·r) shared
  float* lmB;   // (AB, l·r) shared
};

__device__ __forceinline__ float* publish_batch(Ctx& c, const Batch& B) {
  return c.ring + (c.nsum++ % CORA_RING) * B.W;
}

// res[al] = <X_al, Z_al> over the group, for every trial point (dot's
// per-thread order, group_sum's CTA tree and rank order per al).
template <class G>
__device__ void dots(Ctx& c, const Batch& B, const float* X, const float* Z,
                     float* res) {
  float* slot = publish_batch(c, B);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int a = c.P.row_ptr[c.rank] * c.r, b = c.P.row_ptr[c.rank + 1] * c.r;
  for (int al = 0; al < B.AB; ++al) {
    const float* Xa = X + al * B.st;
    const float* Za = Z + al * B.st;
    float acc = 0.f;
    for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
      const int x = own_elem<G>(c, i);
      acc += Xa[x] * Za[x];
    }
    acc = warp_sum(acc);
    if (lane == 0) B.part[al * 32 + wid] = acc;
  }
  __syncthreads();
  for (int al = wid; al < B.AB; al += nw) {
    float x = lane < nw ? B.part[al * 32 + lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) slot[al] = x;
  }
  G::sync();
  for (int al = threadIdx.x; al < B.AB; al += blockDim.x)
    res[al] = ranked_sum<G>(slot, al);
  __syncthreads();
}

// retract(Y, α_al·V) for every trial point into out_al, with
// x = Y + fl(α·V).
template <int D, class G>
__device__ void retract_batch(const Ctx& c, const Batch& B, const float* Y,
                              const float* V, const float* alpha, float* out0) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D, ng = c.g1 - c.g0;
  for (int i = threadIdx.x; i < B.AB * ng; i += blockDim.x) {
    const int al = i / ng, g = c.g0 + i % ng;
    const float scale = alpha[al];
    const float* Yg = Y + (size_t)g * D * r;
    const float* Vg = V + (size_t)g * D * r;
    float* Og = out0 + al * B.st + (size_t)g * D * r;
    float G2[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) G2[a][b] = 0.f;
    for (int j = 0; j < r; ++j) {
      float x[D];
#pragma unroll
      for (int a = 0; a < D; ++a)
        x[a] = Yg[a * r + j] + __fmul_rn(scale, Vg[a * r + j]);
#pragma unroll
      for (int a = 0; a < D; ++a) {
#pragma unroll
        for (int b = 0; b < D; ++b) G2[a][b] += x[a] * x[b];
        Og[a * r + j] = x[a];
      }
    }
    polar_block<D>(P, Og, r, G2);
  }
  const int t0 = P.rng_ptr[c.rank], nt = P.rng_ptr[c.rank + 1] - t0;
  for (int i = threadIdx.x; i < B.AB * nt; i += blockDim.x) {
    const int al = i / nt, e = own_rng<G>(c, t0 + i % nt);
    const float scale = alpha[al];
    const float* y = Y + (size_t)(nd + e) * r;
    const float* v = V + (size_t)(nd + e) * r;
    float* o = out0 + al * B.st + (size_t)(nd + e) * r;
    float nrm2 = 0.f;
    for (int j = 0; j < r; ++j) {
      const float x = y[j] + __fmul_rn(scale, v[j]);
      o[j] = x;
      nrm2 += x * x;
    }
    unit_row(o, r, nrm2);
  }
  int a, b;
  own_tail(c, D, a, b);
  const int nx = b - a;
  for (int i = threadIdx.x; i < B.AB * nx; i += blockDim.x) {
    const int al = i / nx, x = own_elem<G>(c, a + i % nx);
    out0[al * B.st + x] = Y[x] + __fmul_rn(alpha[al], V[x]);
  }
  __syncthreads();
}

// Q·Y_al for every trial point.
template <int D, class G>
__device__ void qv_batch(Ctx& c, const Batch& B, const float* Y0,
                         float* out0) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, l = P.l, lm0 = P.n * D + P.m + P.n, ng = c.g1 - c.g0,
            lr = l * r;
  G::sync();  // the neighbouring poses and the landmark rows of Y
  for (int i = threadIdx.x; i < B.AB * ng * r; i += blockDim.x) {
    const size_t o = (i / (ng * r)) * B.st;
    qv_pose<D>(c, Y0 + o, c.g0 + (i / r) % ng, i % r, out0 + o);
  }
  const int e0 = P.rng_ptr[c.rank], ne = P.rng_ptr[c.rank + 1] - e0;
  for (int i = threadIdx.x; i < B.AB * ne * r; i += blockDim.x) {
    const size_t o = (i / (ne * r)) * B.st;
    qv_bearing<D>(c, Y0 + o, own_rng<G>(c, e0 + (i / r) % ne), i % r,
                  out0 + o);
  }
  // landmark rows: one warp per (trial point, landmark, column)
  if (l > 0) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
              nw = blockDim.x >> 5;
    float* slot = publish_batch(c, B);
    for (int p = wid; p < B.AB * lr; p += nw) {
      const float acc = warp_sum(qv_landmark_lane<D>(
          c, Y0 + (p / lr) * B.st, (p / r) % l, p % r, lane));
      if (lane == 0) slot[p] = acc;
    }
    G::sync();
    if (c.rank == 0)
      for (int p = threadIdx.x; p < B.AB * lr; p += blockDim.x)
        out0[(p / lr) * B.st + (size_t)lm0 * r + p % lr] = ranked_sum<G>(slot, p);
  }
  __syncthreads();
}

// tangent_project(Y_al, V_al) into out_al for every trial point; out may
// alias V.
template <int D, class G>
__device__ void tangent_project_batch(const Ctx& c, const Batch& B,
                                      const float* Y0, const float* V0,
                                      float* out0) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D, ng = c.g1 - c.g0;
  for (int i = threadIdx.x; i < B.AB * ng; i += blockDim.x) {
    const size_t o = (i / ng) * B.st + (size_t)(c.g0 + i % ng) * D * r;
    tangent_pose<D>(Y0 + o, V0 + o, out0 + o, r);
  }
  const int t0 = P.rng_ptr[c.rank], nt = P.rng_ptr[c.rank + 1] - t0;
  for (int i = threadIdx.x; i < B.AB * nt; i += blockDim.x) {
    const size_t o =
        (i / nt) * B.st + (size_t)(nd + own_rng<G>(c, t0 + i % nt)) * r;
    tangent_row(Y0 + o, V0 + o, out0 + o, r);
  }
  if (out0 != V0) {
    int a, b;
    own_tail(c, D, a, b);
    const int nx = b - a;
    for (int i = threadIdx.x; i < B.AB * nx; i += blockDim.x) {
      const size_t x = (i / nx) * B.st + own_elem<G>(c, a + i % nx);
      out0[x] = V0[x];
    }
  }
  __syncthreads();
}

// acc += a·u per component (one FMA each, as the scalar passes do).
__device__ __forceinline__ void fma4(float a, const float4& u, float4& acc) {
  acc.x += a * u.x;
  acc.y += a * u.y;
  acc.z += a * u.z;
  acc.w += a * u.w;
}

// (Q + λI)⁻¹V_al for every trial point: precon_solve's passes on a band of
// B.Rp columns (the rest past AB·r padding nobody reads), so each
// propagator and Linv element is loaded once per four columns and the band
// moves as float4. out must not alias V.
template <int D, class G>
__device__ void precon_batch(Ctx& c, const Batch& B, const float* V0,
                             float* out0) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, RA = B.AB * r, R = B.Rp, R4 = R / 4, l = P.l,
            lm0 = P.n * D + P.m + P.n, lr = l * r;
  const int q = D + 1, w = 2 * q, nb = P.nb;
  const int b0 = c.b0, nown4 = (c.b1 - b0) * w * R4, off4 = b0 * w * R4;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  float* src = c.band0;
  float* dst = c.band1;

  // 1) band right-hand side of the own blocks (the trial points' columns)
  for (int i = threadIdx.x; i < 2 * (c.b1 - b0) * RA; i += blockDim.x) {
    const int g = 2 * b0 + i / RA, col = i % RA;
    band_rhs<D>(c, V0 + (col / r) * B.st, g, col % r,
                src + (size_t)((g >> 1) * w + (g & 1) * q) * R + col, R);
  }
  // landmark right-hand side: this CTA's share of Σ cval·v_s/pivot
  float* rhs = nullptr;
  if (l > 0) {
    rhs = publish_batch(c, B);
    for (int p = wid; p < B.AB * lr; p += nw) {
      const float acc = warp_sum(lm_rhs_lane<D>(
          c, V0 + (p / lr) * B.st, (p / r) % l, p % r, lane));
      if (lane == 0) rhs[p] = acc;
    }
  }
  __syncthreads();

  // 2) u = Linv · b
  {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < nown4; i += blockDim.x) {
      const int cb = b0 + i / (w * R4), e = (i / R4) % w, c4 = i % R4;
      const float* L = P.Linv + (size_t)(cb * w + e) * w;
      const float4* b = s4 + (size_t)cb * w * R4 + c4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int f = 0; f < w; ++f) fma4(L[f], b[f * R4], acc);
      d4[off4 + i] = acc;
    }
  }
  { float* t = src; src = dst; dst = t; }

  // 3) forward doubling levels: u_c += A_k[c] u_{c − 2^k}
  const size_t ww = (size_t)w * w;
  for (int k = 0; k < P.levels; ++k) {
    const int s = 1 << k;
    G::sync();
    const float* A = P.AF + (size_t)k * nb * ww;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < nown4; i += blockDim.x) {
      const int cb = b0 + i / (w * R4), e = (i / R4) % w, c4 = i % R4;
      float4 v = s4[off4 + i];
      if (cb >= s) {
        const float* Ae = A + (size_t)(cb * w + e) * w;
        const float4* u = s4 + (size_t)(cb - s) * w * R4 + c4;
        for (int f = 0; f < w; ++f) fma4(Ae[f], u[f * R4], v);
      }
      d4[off4 + i] = v;
    }
    { float* t = src; src = dst; dst = t; }
  }
  // 4) the exact adjoint, levels reversed: x_c += A_k[c + 2^k]ᵀ x_{c + 2^k}
  for (int k = P.levels - 1; k >= 0; --k) {
    const int s = 1 << k;
    G::sync();
    const float* A = P.AF + ((size_t)k * nb + s) * ww;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < nown4; i += blockDim.x) {
      const int cb = b0 + i / (w * R4), e = (i / R4) % w, c4 = i % R4;
      float4 v = s4[off4 + i];
      if (cb < nb - s) {
        const float* Ab = A + (size_t)cb * w * w + e;
        const float4* x = s4 + (size_t)(cb + s) * w * R4 + c4;
        for (int f = 0; f < w; ++f) fma4(Ab[f * w], x[f * R4], v);
      }
      d4[off4 + i] = v;
    }
    { float* t = src; src = dst; dst = t; }
  }
  __syncthreads();
  // 5) y1 = Linvᵀ · x in place (see precon_solve), four columns a thread
  for (int i = threadIdx.x; i < nown4 / w; i += blockDim.x) {
    const int cb = b0 + i / R4, c4 = i % R4;
    const float* L = P.Linv + (size_t)cb * w * w;
    float4* x = reinterpret_cast<float4*>(src) + (size_t)cb * w * R4 + c4;
    float4 xv[2 * (D + 1)];
#pragma unroll
    for (int f = 0; f < w; ++f) xv[f] = x[f * R4];
#pragma unroll
    for (int e = 0; e < w; ++e) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int f = 0; f < w; ++f) fma4(L[f * w + e], xv[f], acc);
      x[e * R4] = acc;
    }
  }
  __syncthreads();
  const float* y1 = src;

  // 6) Woodbury landmark correction, then the own band blocks to pose rows
  if (l > 0) {
    float* wood = publish_batch(c, B);
    for (int p = wid; p < B.AB * lr; p += nw) {
      const float acc = warp_sum(wood_lane(c, y1 + (p / lr) * r + p % r,
                                           (p / r) % l, R, lane));
      if (lane == 0) wood[p] = acc;
    }
    G::sync();
    for (int p = threadIdx.x; p < B.AB * lr; p += blockDim.x) {
      const float a = V0[(p / lr) * B.st + (size_t)lm0 * r + p % lr] -
                      ranked_sum<G>(rhs, p);
      B.lmB[p] = a - ranked_sum<G>(wood, p);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < B.AB * lr; p += blockDim.x) {
      const int al = p / lr;
      const float acc = capinv_row(P, B.lmB + al * lr, (p / r) % l, p % r, r);
      B.lmA[p] = acc;
      if (c.rank == 0) out0[al * B.st + (size_t)lm0 * r + p % lr] = acc;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < (c.b1 - b0) * w * RA; i += blockDim.x) {
    const int t = b0 * w + i / RA, col = i % RA, al = col / r;
    band_to_pose<D>(c, t, col % r, y1[(size_t)t * R + col], B.lmA + al * lr,
                    out0 + al * B.st);
  }
  __syncthreads();

  // 7) sphere back-substitution of the own ranges
  const int e0 = P.rng_ptr[c.rank], ne = P.rng_ptr[c.rank + 1] - e0;
  for (int i = threadIdx.x; i < B.AB * ne * r; i += blockDim.x) {
    const int al = i / (ne * r);
    sphere_back<D>(c, V0 + al * B.st, B.lmA + al * lr,
                   own_rng<G>(c, e0 + (i / r) % ne), i % r, out0 + al * B.st);
  }
  __syncthreads();
}

// step_core with do_retract for the AB trial points Y + α_al·Ẏ: res
// (3, AB) gets <Yn, QY>, <grad, grad> and <grad, P grad> per trial point.
// Trial point al's states are Yn + al·st, its QY and grad NR and 2·NR
// after it; P·grad goes into QY's rows, dead once grad is formed.
template <int D, class G>
__device__ void ladder_core(Ctx& c, const Batch& B, const float* Y,
                            const float* Ydot, const float* alpha, float* Yn,
                            float* res) {
  const size_t NR = (size_t)c.P.N * c.r;
  float* QY = Yn + NR;
  float* grad = Yn + 2 * NR;
  retract_batch<D, G>(c, B, Y, Ydot, alpha, Yn);
  qv_batch<D, G>(c, B, Yn, QY);
  dots<G>(c, B, Yn, QY, res);
  tangent_project_batch<D, G>(c, B, Yn, QY, grad);
  dots<G>(c, B, grad, grad, res + B.AB);
  precon_batch<D, G>(c, B, grad, QY);
  tangent_project_batch<D, G>(c, B, Yn, QY, QY);
  dots<G>(c, B, grad, QY, res + 2 * B.AB);
}
