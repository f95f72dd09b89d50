// The four TNT kernels of the staircase's main path, for Hopper (sm_90a):
//
//   step   — retraction + f + Riemannian gradient + √<g, Pg>
//            (replaces PallasTNT.step, cora_tpu/ops/pallas_tcg.py:363-398)
//   tcg    — one whole Steihaug–Toint preconditioned tCG solve
//            (replaces PallasTNT.tcg, pallas_tcg.py:401-441)
//   chunk  — TNT outer iterations up to stop_at: tCG, step at the trial
//            point, ρ test, Δ update, stopping rules, ramp/finish, histories
//            (replaces PallasTNT.chunk, pallas_tcg.py:443-753)
//   ladder — (f, ‖grad‖, √<g, Pg>) at retract(Y, α·Ẏ) for every α, the
//            trial points batched over a few clusters
//            (replaces PallasTNT.ladder, pallas_tcg.py:755-804)
//
// chunk, tcg and step are persistent kernels over ONE thread-block cluster
// of CORA_CLUSTER CTAs of 1024 threads on neighbouring SMs (ClusterGroup in
// chain_ops.cuh), launched with cudaLaunchKernelEx and a cluster-dimension
// attribute. chunk is a whole solver loop with data-dependent trip counts,
// group barriers in every pass chain and scalar control flow, so it stays one
// launch per chunk; between chunks only the 12 scalars go back to the host.
// What bounds them is the chain of dependent passes, ~2 µs each, most of
// it the latency of the pass's loads: per tCG iteration 7 ended by a
// cluster barrier (0.76 µs each, scripts/probe_cluster_sync.py) and ~33 by
// a CTA barrier at plaza2's shapes, r = 4, the band scan's 2·cta_levels
// among them; not bytes (a call reads ~5 MB of inputs once; a tCG
// iteration streams ~22 MB of L2, ~20 µs over 16 SMs) or FLOPs.
// The cluster spreads each pass over CORA_CLUSTER SMs' L2 paths and keeps
// the barrier in hardware; the times against one CTA's are in PERF.md.
// Every CTA computes the same scalars from the same rank-ordered cluster
// sums, so the control flow is uniform across the cluster; only CTA 0
// writes the scalars and histories back.
//
// ladder evaluates A (48) trial points of one step each. It launches K
// clusters of CORA_CLUSTER CTAs, cluster k taking a contiguous group of
// about A/K trial points (chain.ladder_groups) and running step's ~28
// dependent passes once for its whole group (ladder_core): the barriers
// and the pass latency are paid once per cluster, and each propagator row
// is read once per pass for the group's AB·r band columns. Its partial-sum
// ring is AB trial points wide, in dynamic shared memory, so AB is at most
// what one block's shared memory holds at this rank: where A/K trial
// points do not fit, the host cuts the A points into more groups and
// launches them K clusters at a time (tnt_kernels.CudaTNT.ladder). A trial
// point's bits do not depend on its group. K is at most the clusters the
// card holds at once (cora_ladder_capacity); chip_smoke.py sweeps it.
//
// Every buffer sized by the rank lives in dynamic shared memory sized at
// launch (chain_smem, ladder_smem), so the kernels take every rank whose
// buffers fit in one block's shared memory (227 KB on the H100):
// chain.rank_bound.
//
// step_block, ladder_block, chunk_block and tcg_block are the single-CTA
// versions (ladder_block: one CTA per α): the comparators that
// chip_smoke.py times against the cluster kernels; the solver never
// launches them.
//
// Plain C interface (bound with ctypes from ops/tnt_kernels.py): each entry
// launches on the given stream, allocates nothing (the caller passes the
// scratch `work`), and returns the launch's CUDA error code. The plan of a
// cluster kernel carries the partition of CORA_CLUSTER parts, that of a
// single-CTA kernel the partition of one part.
#include <utility>

#include "chain_ops.cuh"

#ifndef CORA_CLUSTER
#define CORA_CLUSTER 16
#endif
static_assert(CORA_CLUSTER >= 1 && CORA_CLUSTER <= 16, "cluster of 1..16 CTAs");

namespace {

using Cluster = ClusterGroup<CORA_CLUSTER>;

constexpr int RUNNING = 0, GRAD_TOL = 1, PRECON_GRAD_TOL = 2,
              REL_DECREASE = 3, STEPSIZE = 4, DELTA_TOL = 5, RAMP_EXIT = 8;

struct Carver {
  float* p;
  __device__ float* take(size_t count) {
    float* q = p;
    p += count;
    return q;
  }
};

// The context of this CTA: its share of the partition, the scan scratch,
// and the ring of partial sums and the landmark buffers in the dynamic
// shared memory `smem` (chain_smem_floats(l, r) floats).
template <class G>
__device__ Ctx make_ctx(const ChainPlanArgs& P, int r, Carver& w,
                        float* smem) {
  Ctx c;
  c.P = P;
  c.r = r;
  const size_t band = (size_t)P.nb * P.w * r;
  c.band0 = w.take(band);
  c.band1 = w.take(band);
  c.carry = P.parts > 1 ? w.take((size_t)P.parts * P.w * r) : nullptr;
  c.rank = G::rank();
  c.b0 = P.blk_ptr[c.rank];
  c.b1 = P.blk_ptr[c.rank + 1];
  c.g0 = min(2 * c.b0, P.n);
  c.g1 = min(2 * c.b1, P.n);
  const int lr = P.l * r;
  c.W = lr > 1 ? lr : 1;
  c.ring = smem;
  c.lmA = smem + CORA_RING * c.W;
  c.lmB = c.lmA + lr;
  c.nsum = 0;
  return c;
}

template <int D, class G>
__global__ void __launch_bounds__(CORA_NTHREADS, 1)
step_kernel(ChainPlanArgs P, int r, const float* Y, const float* s,
            int do_retract, float* Yn, float* QY, float* grad, float* scal,
            float* work) {
  extern __shared__ float smem[];
  Carver w{work};
  Ctx c = make_ctx<G>(P, r, w, smem);
  float* pg = w.take((size_t)P.N * r);
  StepOut o = step_core<D, G>(c, Y, s, 1.f, do_retract, Yn, QY, grad, pg);
  if (c.rank == 0 && threadIdx.x == 0) {
    scal[0] = o.f;
    scal[1] = o.gradnorm;
    scal[2] = o.pgradnorm;
  }
  G::sync();  // no CTA leaves while another may still read its ring
}

template <int D, class G>
__global__ void __launch_bounds__(CORA_NTHREADS, 1)
tcg_kernel(ChainPlanArgs P, int r, const float* g, const float* Y,
           const float* nF, float delta, int max_iters, float kappa,
           float theta, float* s, float* scal, float* work) {
  extern __shared__ float smem[];
  Carver w{work};
  Ctx c = make_ctx<G>(P, r, w, smem);
  const size_t NR = (size_t)P.N * r;
  float* rv = w.take(NR);
  float* dv = w.take(NR);
  float* z = w.take(NR);
  float* Hd = w.take(NR);
  TcgOut o = tcg_core<D, G>(c, g, Y, nF, delta, max_iters, kappa, theta, s,
                            rv, dv, z, Hd);
  if (c.rank == 0 && threadIdx.x == 0) {
    scal[0] = o.mdec;
    scal[1] = (float)o.hit;
    scal[2] = (float)o.iters;
    scal[3] = o.step_norm;
  }
  G::sync();  // no CTA leaves while another may still read its ring
}

// fs (8):  [f, gradnorm, pgradnorm, Delta, lift_grad_norm, stall_tol, 0, 0]
// is (12): [k, status, finish, dec_streak, step_streak, stop_at, tcg_cap,
//           ramp_until, ramp_tcg, stall_window, init_flag, 0]
// hist (5, H): f, ‖grad‖, √<g,Pg>, accepted step norm, tCG iterations
// Y, G, NF are updated in place; fs[0:4] and is[0:5] are written back.
template <int D, class G>
__global__ void __launch_bounds__(CORA_NTHREADS, 1)
chunk_kernel(ChainPlanArgs P, TNTArgs T, int r, float* Y, float* Gr,
             float* NF, float* fs, int* is, float* hist, int H,
             float* work) {
  extern __shared__ float smem[];
  Carver w{work};
  Ctx c = make_ctx<G>(P, r, w, smem);
  const size_t NR = (size_t)P.N * r;
  float* s = w.take(NR);
  float* rv = w.take(NR);
  float* dv = w.take(NR);
  float* z = w.take(NR);
  float* Hd = w.take(NR);
  float* Yp = w.take(NR);
  float* QYp = w.take(NR);
  float* Gp = w.take(NR);
  float* pg = w.take(NR);
  const float tiny = FLT_MIN;
  const int ra = P.row_ptr[c.rank] * r, rb = P.row_ptr[c.rank + 1] * r;
  const bool writer = c.rank == 0 && threadIdx.x == 0;

  float f = fs[0], gn = fs[1], pgn = fs[2], Delta = fs[3];
  const float lift_grad_norm = fs[4], stall_tol = fs[5];
  int k = is[0], status = is[1];
  bool finish = is[2] > 0;
  int dec = is[3], stp = is[4];
  const int stop_at = is[5], tcg_cap = is[6], ramp_until = is[7],
            ramp_tcg = is[8], sw = is[9], init = is[10];
  G::sync();  // every thread has read the scalars before any write-back

  if (init == 1) {  // first chunk of a solve: evaluate the start in-kernel
    StepOut o = step_core<D, G>(c, Y, nullptr, 0.f, 0, Y, NF, Gr, pg);
    f = o.f;
    gn = o.gradnorm;
    pgn = o.pgradnorm;
    status = gn <= T.grad_tol ? GRAD_TOL
             : pgn <= T.pgrad_tol ? PRECON_GRAD_TOL
                                  : RUNNING;
  }

  while (k < stop_at && status == RUNNING) {
    const bool in_ramp = !finish && k < ramp_until;
    const TcgOut t = tcg_core<D, G>(c, Gr, Y, NF, Delta,
                                    in_ramp ? ramp_tcg : tcg_cap, T.kappa,
                                    T.theta, s, rv, dv, z, Hd);
    const StepOut o = step_core<D, G>(c, Y, s, 1.f, 1, Yp, QYp, Gp, pg);
    const float rho = (f - o.f) / (t.mdec == 0.f ? tiny : t.mdec);
    const bool accept = rho >= T.eta1 && t.mdec > 0.f;
    if (accept) {
      for (int i = ra + threadIdx.x; i < rb; i += blockDim.x) {
        const int x = own_elem<G>(c, i);
        Y[x] = Yp[x];
        Gr[x] = Gp[x];
        NF[x] = QYp[x];
      }
      __syncthreads();
    }
    const float f_new = accept ? o.f : f;
    if (accept) {
      gn = o.gradnorm;
      pgn = o.pgradnorm;
    }
    const bool very_successful = rho >= T.eta2;
    float Delta_new = !accept ? T.alpha1 * Delta
                      : (very_successful && t.hit) ? T.alpha2 * Delta
                                                   : Delta;
    const float rel_decrease = (f - o.f) / (fabsf(f) + tiny);
    const bool small_decrease = accept && rel_decrease < T.rel_dec_tol;
    const bool small_step = accept && t.step_norm < T.step_tol;
    dec = small_decrease ? dec + 1 : (accept ? 0 : dec);
    stp = small_step ? stp + 1 : (accept ? 0 : stp);
    status = gn <= T.grad_tol          ? GRAD_TOL
             : pgn <= T.pgrad_tol      ? PRECON_GRAD_TOL
             : dec >= 3                ? REL_DECREASE
             : stp >= 3                ? STEPSIZE
             : Delta_new < T.delta_tol ? DELTA_TOL
                                       : RUNNING;
    // histories first: the plateau test below reads the lagged f, which
    // CTA 0 wrote
    if (writer) {
      hist[k] = f_new;
      hist[H + k] = gn;
      hist[2 * H + k] = pgn;
      hist[3 * H + k] = accept ? t.step_norm : 0.f;
      hist[4 * H + k] = (float)t.iters;
    }
    G::sync();
    const float f_lag = hist[k - sw > 0 ? k - sw : 0];
    const bool plateaued = sw > 0 && k >= sw &&
                           (f_lag - f_new) < (float)sw * stall_tol * fabsf(f_new);
    const bool boundary = in_ramp && (k + 1 == ramp_until || plateaued) &&
                          status == RUNNING;
    const bool stall_now =
        status == REL_DECREASE || status == STEPSIZE || status == DELTA_TOL;
    const bool lift_now = boundary && gn > lift_grad_norm;
    const bool promote = (in_ramp && stall_now) ||
                         (boundary && gn <= lift_grad_norm);
    status = lift_now ? RAMP_EXIT : (promote ? RUNNING : status);
    finish = finish || promote;
    if (promote) {
      Delta_new = T.delta0;
      dec = 0;
      stp = 0;
    }
    f = f_new;
    Delta = Delta_new;
    k += 1;
  }

  if (writer) {
    fs[0] = f;
    fs[1] = gn;
    fs[2] = pgn;
    fs[3] = Delta;
    is[0] = k;
    is[1] = status;
    is[2] = finish ? 1 : 0;
    is[3] = dec;
    is[4] = stp;
  }
  G::sync();  // no CTA leaves while another may still read its ring
}

// The comparator: one CTA per signed step length,
// out = [f (A) | ‖grad‖ (A) | √<g,Pg> (A)].
template <int D>
__global__ void __launch_bounds__(CORA_NTHREADS, 1)
ladder_block_kernel(ChainPlanArgs P, int r, const float* Y, const float* Ydot,
                    const float* alphas, int A, float* out, float* work) {
  extern __shared__ float smem[];
  const size_t NR = (size_t)P.N * r;
  const size_t per = 4 * NR + 2 * (size_t)P.nb * P.w * r;
  Carver w{work + blockIdx.x * per};
  Ctx c = make_ctx<BlockGroup>(P, r, w, smem);
  float* Yn = w.take(NR);
  float* QY = w.take(NR);
  float* G = w.take(NR);
  float* pg = w.take(NR);
  const float a = alphas[blockIdx.x];
  StepOut o = step_core<D, BlockGroup>(c, Y, Ydot, a, 1, Yn, QY, G, pg);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = o.f;
    out[A + blockIdx.x] = o.gradnorm;
    out[2 * A + blockIdx.x] = o.pgradnorm;
  }
}

// Dynamic shared memory of the single-state kernels at rank r.
size_t chain_smem(const ChainPlanArgs& P, int r) {
  return sizeof(float) * chain_smem_floats(P.l, r);
}

// Dynamic shared memory of the α-batched ladder for at most `ab` trial
// points per cluster: the ring, the warp partials, lmA, lmB and the sums
// (chain.ladder_smem_bytes; the host picks ab so that it fits).
size_t ladder_smem(const ChainPlanArgs& P, int r, int ab) {
  const int lr = P.l * r;
  const size_t W = (size_t)ab * (lr > 1 ? lr : 1);
  return sizeof(float) *
         (CORA_RING * W + 32 * (size_t)ab + 2 * (size_t)ab * lr + 3 * (size_t)ab);
}

// The α-batched ladder: cluster k of the grid evaluates the trial points
// α[grp[k] .. grp[k+1]) together (ladder_core), its scratch laid out as
// chain.LadderLayout says: trial point a's states at a·3·N·r, cluster k's
// two band buffers in [band_off[k], band_off[k+1]).
// out = [f (A) | ‖grad‖ (A) | √<g,Pg> (A)].
template <int D, class G>
__global__ void __launch_bounds__(CORA_NTHREADS, 1)
ladder_kernel(ChainPlanArgs P, int r, const float* Y, const float* Ydot,
              const float* alphas, int A, const int* grp,
              const long long* band_off, float* out, float* work) {
  extern __shared__ float smem[];
  const int k = blockIdx.x / G::kSize;
  const int a0 = grp[k], AB = grp[k + 1] - a0, lr = P.l * r;
  const size_t NR = (size_t)P.N * r, st = 3 * NR;
  const size_t nbw = (size_t)P.nb * P.w;
  Batch B;
  B.AB = AB;
  B.Rp = (int)((band_off[k + 1] - band_off[k]) / (2 * nbw));
  B.st = st;
  B.W = AB * (lr > 1 ? lr : 1);
  Ctx c;
  c.P = P;
  c.r = r;
  c.band0 = work + band_off[k];
  c.band1 = c.band0 + nbw * B.Rp;
  c.carry = nullptr;  // precon_batch scans the whole band
  c.rank = G::rank();
  c.b0 = P.blk_ptr[c.rank];
  c.b1 = P.blk_ptr[c.rank + 1];
  c.g0 = min(2 * c.b0, P.n);
  c.g1 = min(2 * c.b1, P.n);
  c.ring = smem;
  c.W = B.W;
  c.lmA = c.lmB = nullptr;  // the batch's own, in B
  c.nsum = 0;
  B.part = smem + CORA_RING * B.W;
  B.lmA = B.part + 32 * AB;
  B.lmB = B.lmA + AB * lr;
  float* res = B.lmB + AB * lr;
  ladder_core<D, G>(c, B, Y, Ydot, alphas + a0, work + a0 * st, res);
  if (c.rank == 0)
    for (int al = threadIdx.x; al < AB; al += blockDim.x) {
      const float gn = sqrtf(res[AB + al]), ip = res[2 * AB + al];
      out[a0 + al] = 0.5f * res[al];
      out[A + a0 + al] = gn;
      out[2 * A + a0 + al] = ip > 0.f ? sqrtf(fmaxf(ip, 0.f)) : gn;
    }
  G::sync();  // no CTA leaves while another may still read its ring
}

// The kernel's attributes (a non-portable cluster size, its dynamic shared
// memory) and the configuration of `clusters` clusters of CORA_CLUSTER CTAs
// of CORA_NTHREADS threads.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err;
  template <class... Exp>
  ClusterLaunch(void (*kernel)(Exp...), cudaStream_t st, int clusters = 1,
                size_t smem = 0) {
    err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && smem > 0)
      err = cudaFuncSetAttribute((const void*)kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CORA_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(CORA_CLUSTER * clusters, 1, 1);
    cfg.blockDim = dim3(CORA_NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <class... Exp, class... Act>
int launch_clusters(void (*kernel)(Exp...), cudaStream_t st, int clusters,
                    size_t smem, Act&&... args) {
  ClusterLaunch L(kernel, st, clusters, smem);
  if (L.err != cudaSuccess) return (int)L.err;
  const cudaError_t e =
      cudaLaunchKernelEx(&L.cfg, kernel, std::forward<Act>(args)...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class... Exp, class... Act>
int launch_cluster(void (*kernel)(Exp...), cudaStream_t st, size_t smem,
                   Act&&... args) {
  return launch_clusters(kernel, st, 1, smem, std::forward<Act>(args)...);
}

// A plain launch of `grid` single CTAs with `smem` bytes of dynamic shared
// memory (allowed past the 48 KB default first).
template <class... Exp, class... Act>
int launch_blocks(void (*kernel)(Exp...), int grid, cudaStream_t st,
                  size_t smem, Act&&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, CORA_NTHREADS, smem, st>>>(std::forward<Act>(args)...);
  return (int)cudaGetLastError();
}

// How many clusters of the kernel's configuration fit on the card at once.
template <class... Exp>
int cluster_capacity(void (*kernel)(Exp...), int* clusters, size_t smem = 0) {
  ClusterLaunch L(kernel, nullptr, 1, smem);
  if (L.err != cudaSuccess) return (int)L.err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                             &L.cfg);
}

}  // namespace

extern "C" {

int cora_cluster_size() { return CORA_CLUSTER; }

// Clusters of `chunk` (and so of `step` and `tcg`) at rank r that fit.
int cora_cluster_capacity(const ChainPlanArgs* P, int r, int* clusters) {
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return cluster_capacity(chunk_kernel<2, Cluster>, clusters, smem);
  return cluster_capacity(chunk_kernel<3, Cluster>, clusters, smem);
}

int cora_ladder_capacity(const ChainPlanArgs* P, int r, int ab,
                         int* clusters) {
  const size_t smem = ladder_smem(*P, r, ab);
  if (P->d == 2)
    return cluster_capacity(ladder_kernel<2, Cluster>, clusters, smem);
  return cluster_capacity(ladder_kernel<3, Cluster>, clusters, smem);
}

int cora_step(const ChainPlanArgs* P, int r, const float* Y, const float* s,
              int do_retract, float* Yn, float* QY, float* grad, float* scal,
              float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_cluster(step_kernel<2, Cluster>, st, smem, *P, r, Y, s,
                          do_retract, Yn, QY, grad, scal, work);
  return launch_cluster(step_kernel<3, Cluster>, st, smem, *P, r, Y, s,
                        do_retract, Yn, QY, grad, scal, work);
}

int cora_step_block(const ChainPlanArgs* P, int r, const float* Y,
                    const float* s, int do_retract, float* Yn, float* QY,
                    float* grad, float* scal, float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_blocks(step_kernel<2, BlockGroup>, 1, st, smem, *P, r, Y, s,
                         do_retract, Yn, QY, grad, scal, work);
  return launch_blocks(step_kernel<3, BlockGroup>, 1, st, smem, *P, r, Y, s,
                       do_retract, Yn, QY, grad, scal, work);
}

int cora_tcg(const ChainPlanArgs* P, int r, const float* g, const float* Y,
             const float* nF, float delta, int max_iters, float kappa,
             float theta, float* s, float* scal, float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_cluster(tcg_kernel<2, Cluster>, st, smem, *P, r, g, Y, nF,
                          delta, max_iters, kappa, theta, s, scal, work);
  return launch_cluster(tcg_kernel<3, Cluster>, st, smem, *P, r, g, Y, nF,
                        delta, max_iters, kappa, theta, s, scal, work);
}

int cora_tcg_block(const ChainPlanArgs* P, int r, const float* g,
                   const float* Y, const float* nF, float delta, int max_iters,
                   float kappa, float theta, float* s, float* scal,
                   float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_blocks(tcg_kernel<2, BlockGroup>, 1, st, smem, *P, r, g, Y,
                         nF, delta, max_iters, kappa, theta, s, scal, work);
  return launch_blocks(tcg_kernel<3, BlockGroup>, 1, st, smem, *P, r, g, Y,
                       nF, delta, max_iters, kappa, theta, s, scal, work);
}

int cora_chunk(const ChainPlanArgs* P, const TNTArgs* T, int r, float* Y,
               float* G, float* NF, float* fs, int* is, float* hist, int H,
               float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_cluster(chunk_kernel<2, Cluster>, st, smem, *P, *T, r, Y, G,
                          NF, fs, is, hist, H, work);
  return launch_cluster(chunk_kernel<3, Cluster>, st, smem, *P, *T, r, Y, G,
                        NF, fs, is, hist, H, work);
}

int cora_chunk_block(const ChainPlanArgs* P, const TNTArgs* T, int r,
                     float* Y, float* G, float* NF, float* fs, int* is,
                     float* hist, int H, float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_blocks(chunk_kernel<2, BlockGroup>, 1, st, smem, *P, *T, r,
                         Y, G, NF, fs, is, hist, H, work);
  return launch_blocks(chunk_kernel<3, BlockGroup>, 1, st, smem, *P, *T, r, Y,
                       G, NF, fs, is, hist, H, work);
}

// One launch of `clusters` clusters, cluster k taking the trial points
// [grp[k], grp[k+1]) and the band buffers [band_off[k], band_off[k+1]):
// grp and band_off may point into longer tables (a later pass of the
// host's split), since they hold global trial indices and offsets.
int cora_ladder(const ChainPlanArgs* P, int r, const float* Y,
                const float* Ydot, const float* alphas, int A, const int* grp,
                const long long* band_off, int clusters, int ab, float* out,
                float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ladder_smem(*P, r, ab);
  if (P->d == 2)
    return launch_clusters(ladder_kernel<2, Cluster>, st, clusters, smem, *P,
                           r, Y, Ydot, alphas, A, grp, band_off, out, work);
  return launch_clusters(ladder_kernel<3, Cluster>, st, clusters, smem, *P, r,
                         Y, Ydot, alphas, A, grp, band_off, out, work);
}

int cora_ladder_block(const ChainPlanArgs* P, int r, const float* Y,
                      const float* Ydot, const float* alphas, int A,
                      float* out, float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = chain_smem(*P, r);
  if (P->d == 2)
    return launch_blocks(ladder_block_kernel<2>, A, st, smem, *P, r, Y, Ydot,
                         alphas, A, out, work);
  return launch_blocks(ladder_block_kernel<3>, A, st, smem, *P, r, Y, Ydot,
                       alphas, A, out, work);
}

}  // extern "C"
