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
//   BlockGroup        — one CTA, __syncthreads (step, ladder, and the
//                       single-CTA comparator of chunk and tcg);
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
// the doubling scan: block cb ∓ 2^k) first syncs the group. Elementwise
// passes and dot products run over the CTA's own rows; one CTA owns every
// row in canonical order, so BlockGroup indexes the state directly. State,
// scratch and the propagators live in global memory: at the reference
// datasets' sizes the working set is a few MB and stays in the 50 MB L2.
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
// r ≤ 10, far below a wgmma tile, and TF32 would change the float32 results.
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

#define CORA_RMAX 10
#define CORA_LMAX 16
#define CORA_NTHREADS 1024
// partial-sum slots per CTA, reused round-robin: a slot is written again
// four publications later, after at least two group barriers past its reads
#define CORA_RING 4
#define CORA_RING_W (CORA_LMAX * CORA_RMAX)

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
  float* ring;   // (CORA_RING, CORA_RING_W) this CTA's published partials
  int nsum;      // publications so far
};

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
  return c.ring + (c.nsum++ % CORA_RING) * CORA_RING_W;
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
// Q·Y (reference CORA_problem.cpp:742-757, factored edge form)
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void qv(Ctx& c, const float* Y, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, m = P.m, l = P.l, nd = n * D, tr0 = nd + m,
            lm0 = tr0 + n;
  G::sync();  // the neighbouring poses and the landmark rows of Y
  // pose rotation and translation rows: one thread per (own pose, column)
  for (int i = threadIdx.x; i < (c.g1 - c.g0) * r; i += blockDim.x) {
    const int g = c.g0 + i / r, j = i % r;
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
  // bearing rows of the own ranges
  const int e0 = P.rng_ptr[c.rank], e1 = P.rng_ptr[c.rank + 1];
  for (int i = threadIdx.x; i < (e1 - e0) * r; i += blockDim.x) {
    const int e = own_rng<G>(c, e0 + i / r), j = i % r;
    const int g = P.rng_pose[e], k = P.rng_lm[e];
    const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                    Y[(size_t)(lm0 + k) * r + j] -
                    Y[(size_t)(tr0 + g) * r + j];
    out[(size_t)(nd + e) * r + j] = P.rr[e] * (P.om[e] * v);
  }
  // landmark rows: one warp per (landmark, column) sums the own ranges in
  // fixed lane order; the group's partials are summed in rank order
  if (l > 0) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
              nw = blockDim.x >> 5;
    float* slot = publish_slot(c);
    for (int p = wid; p < l * r; p += nw) {
      const int k = p / r, j = p % r;
      const int t0 = P.lmc_ptr[c.rank * l + k], t1 = P.lmc_ptr[c.rank * l + k + 1];
      float acc = 0.f;
      for (int t = t0 + lane; t < t1; t += 32) {
        const int e = P.lmc_rng[t], g = P.rng_pose[e];
        const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                        Y[(size_t)(lm0 + k) * r + j] -
                        Y[(size_t)(tr0 + g) * r + j];
        acc += P.om[e] * v;
      }
      acc = warp_sum(acc);
      if (lane == 0) slot[p] = acc;
    }
    G::sync();
    if (c.rank == 0)
      for (int p = threadIdx.x; p < l * r; p += blockDim.x)
        out[(size_t)lm0 * r + p] = ranked_sum<G>(slot, p);
  }
  __syncthreads();
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

// ---------------------------------------------------------------------------
// Projection onto T_Y (reference CORA_problem.cpp:782-820); out may alias V
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void tangent_project(const Ctx& c, const float* Y, const float* V,
                                float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D;
  for (int g = c.g0 + threadIdx.x; g < c.g1; g += blockDim.x) {
    const float* Yg = Y + (size_t)g * D * r;
    const float* Vg = V + (size_t)g * D * r;
    float* Og = out + (size_t)g * D * r;
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
  for (int t = P.rng_ptr[c.rank] + threadIdx.x; t < P.rng_ptr[c.rank + 1];
       t += blockDim.x) {
    const int e = own_rng<G>(c, t);
    const float* y = Y + (size_t)(nd + e) * r;
    const float* v = V + (size_t)(nd + e) * r;
    float* o = out + (size_t)(nd + e) * r;
    float inner = 0.f;
    for (int j = 0; j < r; ++j) inner += y[j] * v[j];
    for (int j = 0; j < r; ++j) o[j] = v[j] - inner * y[j];
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
  __shared__ float lmA[CORA_LMAX * CORA_RMAX];
  __shared__ float lmB[CORA_LMAX * CORA_RMAX];
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, l = P.l, nd = n * D, tr0 = nd + P.m,
            lm0 = tr0 + n;
  const int q = D + 1, w = 2 * q, nb = P.nb, nbw = nb * w;
  const int b0 = c.b0, nown = (c.b1 - b0) * w * r, off = b0 * w * r;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  float* src = c.band0;
  float* dst = c.band1;

  // 1) band right-hand side of the own blocks: pose rows, translations +
  //    Σ cval·v_s/pivot
  for (int i = threadIdx.x; i < 2 * (c.b1 - b0) * r; i += blockDim.x) {
    const int g = 2 * b0 + i / r, j = i % r;
    float* b = src + (size_t)((g >> 1) * w + (g & 1) * q) * r + j;
    if (g < n) {
#pragma unroll
      for (int a = 0; a < D; ++a) b[a * r] = V[(size_t)(g * D + a) * r + j];
      float t = V[(size_t)(tr0 + g) * r + j];
      for (int s = 0; s < P.S; ++s) {
        const int e = P.slot[g * P.S + s];
        if (e < 0) break;
        t += P.cval[e] * (P.spiv[e] * V[(size_t)(nd + e) * r + j]);
      }
      b[D * r] = t;
    } else {
#pragma unroll
      for (int a = 0; a <= D; ++a) b[a * r] = 0.f;
    }
  }
  // landmark right-hand side V_lm − Σ cval·v_s/pivot: this CTA's share of
  // the sum, combined after the Woodbury barrier
  float* rhs = nullptr;
  if (l > 0) {
    rhs = publish_slot(c);
    for (int p = wid; p < l * r; p += nw) {
      const int k = p / r, j = p % r;
      const int t0 = P.lmc_ptr[c.rank * l + k], t1 = P.lmc_ptr[c.rank * l + k + 1];
      float acc = 0.f;
      for (int t = t0 + lane; t < t1; t += 32) {
        const int e = P.lmc_rng[t];
        acc += P.cval[e] * (P.spiv[e] * V[(size_t)(nd + e) * r + j]);
      }
      acc = warp_sum(acc);
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
  // 5) y1 = Linvᵀ · x
  for (int i = threadIdx.x; i < nown; i += blockDim.x) {
    const int cb = b0 + i / (w * r), e = (i / r) % w, j = i % r;
    const float* L = P.Linv + (size_t)cb * w * w + e;
    const float* x = src + (size_t)cb * w * r + j;
    float acc = 0.f;
    for (int f = 0; f < w; ++f) acc += L[f * w] * x[f * r];
    dst[off + i] = acc;
  }
  __syncthreads();
  const float* y1 = dst;

  // 6) Woodbury landmark correction (every CTA holds the l × r result),
  //    then scatter the own band blocks to pose rows
  if (l > 0) {
    float* wood = publish_slot(c);
    for (int p = wid; p < l * r; p += nw) {
      const int k = p / r, j = p % r;
      const float* Ck = P.Ct + (size_t)k * nbw;
      float acc = 0.f;
      for (int t = b0 * w + lane; t < c.b1 * w; t += 32)
        acc += Ck[t] * y1[(size_t)t * r + j];
      acc = warp_sum(acc);
      if (lane == 0) wood[p] = acc;
    }
    G::sync();
    for (int p = threadIdx.x; p < l * r; p += blockDim.x) {
      const float a = V[(size_t)lm0 * r + p] - ranked_sum<G>(rhs, p);
      lmB[p] = a - ranked_sum<G>(wood, p);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < l * r; p += blockDim.x) {
      const int k = p / r, j = p % r;
      float acc = 0.f;
      for (int kk = 0; kk < l; ++kk) acc += P.capinv[k * l + kk] * lmB[kk * r + j];
      lmA[p] = acc;
      if (c.rank == 0) out[(size_t)(lm0 + k) * r + j] = acc;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nown; i += blockDim.x) {
    const int t = b0 * w + i / r, j = i % r;
    const int cb = t / w, e = t % w;
    const int g = 2 * cb + e / q, a = e % q;
    if (g >= n) continue;
    float v = y1[off + i];
    for (int k = 0; k < l; ++k) v -= P.BinvCt[(size_t)k * nbw + t] * lmA[k * r + j];
    const int row = a < D ? g * D + a : tr0 + g;
    out[(size_t)row * r + j] = v;
  }
  __syncthreads();

  // 7) sphere back-substitution of the own ranges:
  //    x_s = (v_s − cval (x_lm − x_pose)) / pivot
  const int e0 = P.rng_ptr[c.rank], e1 = P.rng_ptr[c.rank + 1];
  for (int i = threadIdx.x; i < (e1 - e0) * r; i += blockDim.x) {
    const int e = own_rng<G>(c, e0 + i / r), j = i % r;
    const int g = P.rng_pose[e], k = P.rng_lm[e];
    out[(size_t)(nd + e) * r + j] =
        P.spiv[e] * (V[(size_t)(nd + e) * r + j] -
                     P.cval[e] * (lmA[k * r + j] - out[(size_t)(tr0 + g) * r + j]));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Manifold projection of A = Y + scale·V (V may be null): d=2 closed-form
// polar with a shift of singular blocks, d=3 QDWH (8 iterations, 3×3
// Cholesky), bearing rows normalised (reference CORA_problem.cpp:905-938).
// out must not alias Y or V.
// ---------------------------------------------------------------------------
template <int D, class G>
__device__ void retract(const Ctx& c, const float* Y, const float* V,
                        float scale, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, nd = P.n * D;
  const float tiny = FLT_MIN;
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
    const float nrm = fmaxf(sqrtf(nrm2), tiny);
    for (int j = 0; j < r; ++j) o[j] = o[j] / nrm;
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
