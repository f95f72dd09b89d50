// Device functions of the TNT hot loop on the canonical (N, r) row-major
// state of a chain graph: Q·Y, tangent projection, Riemannian Hessian-vector
// product, the banded + Woodbury preconditioner solve, the manifold
// projection and a deterministic block reduction.
//
// They replace the `TileOps` math of the JAX package's Pallas kernels
// (cora_tpu/ops/tiles.py: qv :465, dot :550, tangent_project :557,
// hvp :591, precon_solve :647 with _solve_B :750, project_manifold :787).
// Their plain PyTorch versions, with the same names and semantics, are in
// cora_tpu_torch/ops/chain.py; the host plan they read is
// `build_chain_plan` there.
//
// Execution model: every function is called by ALL threads of ONE thread
// block (a persistent single-CTA kernel, or one CTA per trial point in the
// ladder kernel). Threads stride over poses, ranges, band entries or state
// elements; each function ends with barrier(), so its output is complete
// and visible to the block when it returns. State and scratch live in
// global memory: at the sizes of the reference datasets the working set is
// a few MB and stays in the 50 MB L2. One SM does all the work, so what
// should bound these functions is that SM's L2 traffic for the
// doubling-scan propagators (one (nb, w, w) level per barrier) and the
// barriers themselves, not the card's FLOP rate (not yet measured: no
// per-kernel trace). A later change can spread them over a cooperative
// grid by replacing barrier().
//
// Reductions are deterministic: fixed thread-to-element assignment, warp
// shuffles and a fixed-order tree — no float atomics — so two runs from
// one start give the same trajectory.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define CORA_RMAX 10
#define CORA_LMAX 16
#define CORA_NTHREADS 1024

// Host-built constants of one problem (see ChainPlan in ops/chain.py).
// Edge g joins pose g to g+1; the band is the pose-pair blocking of the
// banded factor (block c rows: R_2c (d rows), t_2c, R_2c+1, t_2c+1).
struct ChainPlanArgs {
  int d, n, m, l, N, nb, w, S, levels, pad_;
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
};

// TNT parameters (types.TNTParams), as float32 like the solve.
struct TNTArgs {
  float eta1, eta2, alpha1, alpha2, delta0;
  float grad_tol, pgrad_tol, rel_dec_tol, step_tol, delta_tol;
  float kappa, theta;
};

// What one call of the device functions works on.
struct Ctx {
  ChainPlanArgs P;
  int r;
  float* band0;  // (nb, w, r) scratch
  float* band1;  // (nb, w, r) scratch
};

// The one synchronisation point of the block: a cooperative-grid version
// would put grid.sync() here.
__device__ __forceinline__ void barrier() { __syncthreads(); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum
}

// Sum of one value per thread, returned to every thread (fixed order).
__device__ float block_sum(float v) {
  __shared__ float part[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) part[wid] = v;
  barrier();
  if (wid == 0) {
    float x = lane < nw ? part[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) total = x;
  }
  barrier();
  const float out = total;
  barrier();
  return out;
}

// <A, B> over `count` elements.
__device__ float dot(const float* A, const float* B, int count) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += A[i] * B[i];
  return block_sum(acc);
}

__device__ void copy_state(const float* src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  barrier();
}

// ---------------------------------------------------------------------------
// Q·Y (reference CORA_problem.cpp:742-757, factored edge form)
// ---------------------------------------------------------------------------
template <int D>
__device__ void qv(const Ctx& c, const float* Y, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, m = P.m, nd = n * D, tr0 = nd + m,
            lm0 = tr0 + n;
  // pose rotation and translation rows: one thread per (pose, column)
  for (int i = threadIdx.x; i < n * r; i += blockDim.x) {
    const int g = i / r, j = i % r;
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
  // bearing rows
  for (int i = threadIdx.x; i < m * r; i += blockDim.x) {
    const int e = i / r, j = i % r;
    const int g = P.rng_pose[e], k = P.rng_lm[e];
    const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                    Y[(size_t)(lm0 + k) * r + j] -
                    Y[(size_t)(tr0 + g) * r + j];
    out[(size_t)(nd + e) * r + j] = P.rr[e] * (P.om[e] * v);
  }
  // landmark rows: one warp per (landmark, column), lanes in fixed order
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  for (int p = wid; p < P.l * r; p += nw) {
    const int k = p / r, j = p % r;
    float acc = 0.f;
    for (int t = P.lm_ptr[k] + lane; t < P.lm_ptr[k + 1]; t += 32) {
      const int e = P.lm_rng[t], g = P.rng_pose[e];
      const float v = P.rr[e] * Y[(size_t)(nd + e) * r + j] +
                      Y[(size_t)(lm0 + k) * r + j] -
                      Y[(size_t)(tr0 + g) * r + j];
      acc += P.om[e] * v;
    }
    acc = warp_sum(acc);
    if (lane == 0) out[(size_t)(lm0 + k) * r + j] = acc;
  }
  barrier();
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
template <int D>
__device__ void tangent_project(const Ctx& c, const float* Y, const float* V,
                                float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, m = P.m, nd = n * D;
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
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
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    const float* y = Y + (size_t)(nd + e) * r;
    const float* v = V + (size_t)(nd + e) * r;
    float* o = out + (size_t)(nd + e) * r;
    float inner = 0.f;
    for (int j = 0; j < r; ++j) inner += y[j] * v[j];
    for (int j = 0; j < r; ++j) o[j] = v[j] - inner * y[j];
  }
  if (out != V) {
    for (int i = (nd + m) * r + threadIdx.x; i < P.N * r; i += blockDim.x)
      out[i] = V[i];
  }
  barrier();
}

// ---------------------------------------------------------------------------
// Riemannian Hessian-vector product (reference CORA_problem.cpp:822-867):
// Proj_TY(Q Ẏ − sym(Y ∇Fᵀ) Ẏ per pose, − <∇F, y> ẏ per bearing row)
// ---------------------------------------------------------------------------
template <int D>
__device__ void hvp(const Ctx& c, const float* Y, const float* nF,
                    const float* dY, float* out) {
  qv<D>(c, dY, out);
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, m = P.m, nd = n * D;
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
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
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
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
  barrier();
}

// ---------------------------------------------------------------------------
// (Q + λI)⁻¹V: sphere elimination → banded doubling scan and its exact
// adjoint → Woodbury landmark correction → sphere back-substitution.
// out must not alias V.
// ---------------------------------------------------------------------------
template <int D>
__device__ void precon_solve(const Ctx& c, const float* V, float* out) {
  __shared__ float lmA[CORA_LMAX * CORA_RMAX];
  __shared__ float lmB[CORA_LMAX * CORA_RMAX];
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, m = P.m, l = P.l, nd = n * D, tr0 = nd + m,
            lm0 = tr0 + n;
  const int q = D + 1, w = 2 * q, nb = P.nb, nbw = nb * w;
  const int nband = nbw * r;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  float* src = c.band0;
  float* dst = c.band1;

  // 1) band right-hand side: pose rows, translations + Σ cval·v_s/pivot
  for (int i = threadIdx.x; i < 2 * nb * r; i += blockDim.x) {
    const int g = i / r, j = i % r;
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
  // landmark right-hand side: V_lm − Σ cval·v_s/pivot
  for (int p = wid; p < l * r; p += nw) {
    const int k = p / r, j = p % r;
    float acc = 0.f;
    for (int t = P.lm_ptr[k] + lane; t < P.lm_ptr[k + 1]; t += 32) {
      const int e = P.lm_rng[t];
      acc += P.cval[e] * (P.spiv[e] * V[(size_t)(nd + e) * r + j]);
    }
    acc = warp_sum(acc);
    if (lane == 0) lmA[p] = V[(size_t)(lm0 + k) * r + j] - acc;
  }
  barrier();

  // 2) u = Linv · b, block by block
  for (int i = threadIdx.x; i < nband; i += blockDim.x) {
    const int cb = i / (w * r), e = (i / r) % w, j = i % r;
    const float* L = P.Linv + (size_t)(cb * w + e) * w;
    const float* b = src + (size_t)cb * w * r + j;
    float acc = 0.f;
    for (int f = 0; f < w; ++f) acc += L[f] * b[f * r];
    dst[i] = acc;
  }
  barrier();
  { float* t = src; src = dst; dst = t; }

  // 3) forward doubling levels: u_c += A_k[c] u_{c − 2^k}
  for (int k = 0; k < P.levels; ++k) {
    const int s = 1 << k;
    const float* A = P.AF + (size_t)k * nb * w * w;
    for (int i = threadIdx.x; i < nband; i += blockDim.x) {
      const int cb = i / (w * r), e = (i / r) % w, j = i % r;
      float v = src[i];
      if (cb >= s) {
        const float* Ae = A + (size_t)(cb * w + e) * w;
        const float* u = src + (size_t)(cb - s) * w * r + j;
        for (int f = 0; f < w; ++f) v += Ae[f] * u[f * r];
      }
      dst[i] = v;
    }
    barrier();
    { float* t = src; src = dst; dst = t; }
  }
  // 4) the exact adjoint, levels reversed: x_c += A_k[c + 2^k]ᵀ x_{c + 2^k}
  for (int k = P.levels - 1; k >= 0; --k) {
    const int s = 1 << k;
    const float* A = P.AF + (size_t)k * nb * w * w;
    for (int i = threadIdx.x; i < nband; i += blockDim.x) {
      const int cb = i / (w * r), e = (i / r) % w, j = i % r;
      float v = src[i];
      if (cb < nb - s) {
        const float* Ab = A + (size_t)(cb + s) * w * w + e;
        const float* x = src + (size_t)(cb + s) * w * r + j;
        for (int f = 0; f < w; ++f) v += Ab[f * w] * x[f * r];
      }
      dst[i] = v;
    }
    barrier();
    { float* t = src; src = dst; dst = t; }
  }
  // 5) y1 = Linvᵀ · x
  for (int i = threadIdx.x; i < nband; i += blockDim.x) {
    const int cb = i / (w * r), e = (i / r) % w, j = i % r;
    const float* L = P.Linv + (size_t)cb * w * w + e;
    const float* x = src + (size_t)cb * w * r + j;
    float acc = 0.f;
    for (int f = 0; f < w; ++f) acc += L[f * w] * x[f * r];
    dst[i] = acc;
  }
  barrier();
  const float* y1 = dst;

  // 6) Woodbury landmark correction, then scatter the band to pose rows
  if (l > 0) {
    for (int p = wid; p < l * r; p += nw) {
      const int k = p / r, j = p % r;
      const float* Ck = P.Ct + (size_t)k * nbw;
      float acc = 0.f;
      for (int t = lane; t < nbw; t += 32) acc += Ck[t] * y1[(size_t)t * r + j];
      acc = warp_sum(acc);
      if (lane == 0) lmB[p] = lmA[p] - acc;
    }
    barrier();
    for (int p = threadIdx.x; p < l * r; p += blockDim.x) {
      const int k = p / r, j = p % r;
      float acc = 0.f;
      for (int kk = 0; kk < l; ++kk) acc += P.capinv[k * l + kk] * lmB[kk * r + j];
      lmA[p] = acc;
      out[(size_t)(lm0 + k) * r + j] = acc;
    }
    barrier();
  }
  for (int i = threadIdx.x; i < nband; i += blockDim.x) {
    const int t = i / r, j = i % r;
    const int cb = t / w, e = t % w;
    const int g = 2 * cb + e / q, a = e % q;
    if (g >= n) continue;
    float v = y1[i];
    for (int k = 0; k < l; ++k) v -= P.BinvCt[(size_t)k * nbw + t] * lmA[k * r + j];
    const int row = a < D ? g * D + a : tr0 + g;
    out[(size_t)row * r + j] = v;
  }
  barrier();

  // 7) sphere back-substitution: x_s = (v_s − cval (x_lm − x_pose)) / pivot
  for (int i = threadIdx.x; i < m * r; i += blockDim.x) {
    const int e = i / r, j = i % r;
    const int g = P.rng_pose[e], k = P.rng_lm[e];
    out[(size_t)(nd + e) * r + j] =
        P.spiv[e] * (V[(size_t)(nd + e) * r + j] -
                     P.cval[e] * (out[(size_t)(lm0 + k) * r + j] -
                                  out[(size_t)(tr0 + g) * r + j]));
  }
  barrier();
}

// ---------------------------------------------------------------------------
// Manifold projection of A = Y + scale·V (V may be null): d=2 closed-form
// polar with a shift of singular blocks, d=3 QDWH (8 iterations, 3×3
// Cholesky), bearing rows normalised (reference CORA_problem.cpp:905-938).
// out must not alias Y or V.
// ---------------------------------------------------------------------------
template <int D>
__device__ void retract(const Ctx& c, const float* Y, const float* V,
                        float scale, float* out) {
  const ChainPlanArgs& P = c.P;
  const int r = c.r, n = P.n, m = P.m, nd = n * D;
  const float tiny = FLT_MIN;
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
    const float* Yg = Y + (size_t)g * D * r;
    const float* Vg = V ? V + (size_t)g * D * r : nullptr;
    float* Og = out + (size_t)g * D * r;
    float G[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) G[a][b] = 0.f;
    for (int j = 0; j < r; ++j) {
      float x[D];
#pragma unroll
      for (int a = 0; a < D; ++a)
        x[a] = Vg ? Yg[a * r + j] + scale * Vg[a * r + j] : Yg[a * r + j];
#pragma unroll
      for (int a = 0; a < D; ++a) {
#pragma unroll
        for (int b = 0; b < D; ++b) G[a][b] += x[a] * x[b];
        Og[a * r + j] = x[a];
      }
    }
    if constexpr (D == 2) {
      const float tr0 = G[0][0] + G[1][1];
      const float det0 = G[0][0] * G[1][1] - G[0][1] * G[0][1];
      const float shift = det0 < 1e-6f * fmaxf(tr0 * tr0, tiny) ? 1e-3f * tr0 : 0.f;
      const float G00 = G[0][0] + shift, G11 = G[1][1] + shift, G01 = G[0][1];
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
      for (int a = 0; a < D; ++a) fro2 += G[a][a];
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
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
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
  for (int i = (nd + m) * r + threadIdx.x; i < P.N * r; i += blockDim.x)
    out[i] = V ? Y[i] + scale * V[i] : Y[i];
  barrier();
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
template <int D>
__device__ StepOut step_core(const Ctx& c, const float* Y, const float* V,
                             float scale, int do_retract, float* Yn,
                             float* QY, float* grad, float* pg) {
  const int NR = c.P.N * c.r;
  if (do_retract)
    retract<D>(c, Y, V, scale, Yn);
  else if (Yn != Y)
    copy_state(Y, Yn, NR);
  qv<D>(c, Yn, QY);
  StepOut o;
  o.f = 0.5f * dot(Yn, QY, NR);
  tangent_project<D>(c, Yn, QY, grad);
  o.gradnorm = sqrtf(dot(grad, grad, NR));
  precon_solve<D>(c, grad, pg);
  tangent_project<D>(c, Yn, pg, pg);
  const float ip = dot(grad, pg, NR);
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
template <int D>
__device__ TcgOut tcg_core(const Ctx& c, const float* g, const float* Y,
                           const float* nF, float delta, int miters,
                           float kappa, float theta, float* s, float* rv,
                           float* dv, float* z, float* Hd) {
  const int NR = c.P.N * c.r;
  const float tiny = FLT_MIN;
  precon_solve<D>(c, g, z);
  tangent_project<D>(c, Y, z, z);
  const float rz0 = dot(g, z, NR);
  // x^θ as exp(θ log x), as the TPU kernel computes it
  const float sq = sqrtf(fmaxf(rz0, 0.f)) + tiny;
  const float mk = fminf(kappa, expf(theta * logf(sq)));
  const float rz_stop = rz0 * (mk * mk);
  for (int i = threadIdx.x; i < NR; i += blockDim.x) {
    s[i] = 0.f;
    rv[i] = g[i];
    dv[i] = -z[i];
  }
  barrier();
  float rz = rz0, phi = 0.f, sigma = 0.f, dmd = rz0, mdec = 0.f;
  int k = 0;
  bool done = rz0 <= 0.f, hit = false;
  while (k < miters && !done) {
    hvp<D>(c, Y, nF, dv, Hd);
    const float dHd = dot(dv, Hd, NR);
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
    for (int i = threadIdx.x; i < NR; i += blockDim.x) {
      s[i] += coef * dv[i];
      rv[i] += alpha * Hd[i];
    }
    barrier();
    precon_solve<D>(c, rv, z);
    tangent_project<D>(c, Y, z, z);
    const float rz_new = dot(rv, z, NR);
    const bool converged = rz_new <= rz_stop;
    const float beta = rz_new / (rz == 0.f ? tiny : rz);
    for (int i = threadIdx.x; i < NR; i += blockDim.x)
      dv[i] = -z[i] + beta * dv[i];
    barrier();
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
  o.step_norm = sqrtf(dot(s, s, NR));
  return o;
}
