// The four TNT kernels of the staircase's main path, for Hopper (sm_90a):
//
//   step   — retraction + f + Riemannian gradient + √<g, Pg>
//            (replaces PallasTNT.step, cora_tpu/ops/pallas_tcg.py:363-398)
//   tcg    — one whole Steihaug–Toint preconditioned tCG solve
//            (replaces PallasTNT.tcg, pallas_tcg.py:401-441)
//   chunk  — TNT outer iterations up to stop_at: tCG, step at the trial
//            point, ρ test, Δ update, stopping rules, ramp/finish, histories
//            (replaces PallasTNT.chunk, pallas_tcg.py:443-753)
//   ladder — (f, ‖grad‖, √<g, Pg>) at retract(Y, α·Ẏ) for every α, one CTA
//            per α (replaces PallasTNT.ladder, pallas_tcg.py:755-804)
//
// step, tcg and chunk are persistent single-CTA kernels of 1024 threads:
// the Pallas design's counterpart, where one core holds everything. chunk
// is a whole solver loop with data-dependent trip counts, a barrier per
// scan level and scalar control flow, so it stays one kernel launch per
// chunk; between chunks only the 12 scalars go back to the host. Every
// thread computes the same scalars from the same block-reduced values, so
// the control flow is uniform across the block.
//
// Plain C interface (bound with ctypes from ops/tnt_kernels.py): each entry
// launches on the given stream, allocates nothing (the caller passes the
// scratch `work`), and returns cudaGetLastError() after the launch.
#include "chain_ops.cuh"

namespace {

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

__device__ Ctx make_ctx(const ChainPlanArgs& P, int r, Carver& w) {
  Ctx c;
  c.P = P;
  c.r = r;
  const size_t band = (size_t)P.nb * P.w * r;
  c.band0 = w.take(band);
  c.band1 = w.take(band);
  return c;
}

template <int D>
__global__ void __launch_bounds__(CORA_NTHREADS)
step_kernel(ChainPlanArgs P, int r, const float* Y, const float* s,
            int do_retract, float* Yn, float* QY, float* grad, float* scal,
            float* work) {
  Carver w{work};
  Ctx c = make_ctx(P, r, w);
  float* pg = w.take((size_t)P.N * r);
  StepOut o = step_core<D>(c, Y, s, 1.f, do_retract, Yn, QY, grad, pg);
  if (threadIdx.x == 0) {
    scal[0] = o.f;
    scal[1] = o.gradnorm;
    scal[2] = o.pgradnorm;
  }
}

template <int D>
__global__ void __launch_bounds__(CORA_NTHREADS)
tcg_kernel(ChainPlanArgs P, int r, const float* g, const float* Y,
           const float* nF, float delta, int max_iters, float kappa,
           float theta, float* s, float* scal, float* work) {
  Carver w{work};
  Ctx c = make_ctx(P, r, w);
  const size_t NR = (size_t)P.N * r;
  float* rv = w.take(NR);
  float* dv = w.take(NR);
  float* z = w.take(NR);
  float* Hd = w.take(NR);
  TcgOut o = tcg_core<D>(c, g, Y, nF, delta, max_iters, kappa, theta, s, rv,
                         dv, z, Hd);
  if (threadIdx.x == 0) {
    scal[0] = o.mdec;
    scal[1] = (float)o.hit;
    scal[2] = (float)o.iters;
    scal[3] = o.step_norm;
  }
}

// fs (8):  [f, gradnorm, pgradnorm, Delta, lift_grad_norm, stall_tol, 0, 0]
// is (12): [k, status, finish, dec_streak, step_streak, stop_at, tcg_cap,
//           ramp_until, ramp_tcg, stall_window, init_flag, 0]
// hist (5, H): f, ‖grad‖, √<g,Pg>, accepted step norm, tCG iterations
// Y, G, NF are updated in place; fs[0:4] and is[0:5] are written back.
template <int D>
__global__ void __launch_bounds__(CORA_NTHREADS)
chunk_kernel(ChainPlanArgs P, TNTArgs T, int r, float* Y, float* G,
             float* NF, float* fs, int* is, float* hist, int H,
             float* work) {
  Carver w{work};
  Ctx c = make_ctx(P, r, w);
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

  float f = fs[0], gn = fs[1], pgn = fs[2], Delta = fs[3];
  const float lift_grad_norm = fs[4], stall_tol = fs[5];
  int k = is[0], status = is[1];
  bool finish = is[2] > 0;
  int dec = is[3], stp = is[4];
  const int stop_at = is[5], tcg_cap = is[6], ramp_until = is[7],
            ramp_tcg = is[8], sw = is[9], init = is[10];
  barrier();  // every thread has read the scalars before any write-back

  if (init == 1) {  // first chunk of a solve: evaluate the start in-kernel
    StepOut o = step_core<D>(c, Y, nullptr, 0.f, 0, Y, NF, G, pg);
    f = o.f;
    gn = o.gradnorm;
    pgn = o.pgradnorm;
    status = gn <= T.grad_tol ? GRAD_TOL
             : pgn <= T.pgrad_tol ? PRECON_GRAD_TOL
                                  : RUNNING;
  }

  while (k < stop_at && status == RUNNING) {
    const bool in_ramp = !finish && k < ramp_until;
    const TcgOut t = tcg_core<D>(c, G, Y, NF, Delta,
                                 in_ramp ? ramp_tcg : tcg_cap, T.kappa,
                                 T.theta, s, rv, dv, z, Hd);
    const StepOut o = step_core<D>(c, Y, s, 1.f, 1, Yp, QYp, Gp, pg);
    const float rho = (f - o.f) / (t.mdec == 0.f ? tiny : t.mdec);
    const bool accept = rho >= T.eta1 && t.mdec > 0.f;
    if (accept) {
      for (size_t i = threadIdx.x; i < NR; i += blockDim.x) {
        Y[i] = Yp[i];
        G[i] = Gp[i];
        NF[i] = QYp[i];
      }
      barrier();
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
    // histories first: the plateau test below reads the lagged f
    if (threadIdx.x == 0) {
      hist[k] = f_new;
      hist[H + k] = gn;
      hist[2 * H + k] = pgn;
      hist[3 * H + k] = accept ? t.step_norm : 0.f;
      hist[4 * H + k] = (float)t.iters;
    }
    barrier();
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

  if (threadIdx.x == 0) {
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
}

// One CTA per signed step length: out = [f (A) | ‖grad‖ (A) | √<g,Pg> (A)].
template <int D>
__global__ void __launch_bounds__(CORA_NTHREADS)
ladder_kernel(ChainPlanArgs P, int r, const float* Y, const float* Ydot,
              const float* alphas, int A, float* out, float* work) {
  const size_t NR = (size_t)P.N * r;
  const size_t per = 4 * NR + 2 * (size_t)P.nb * P.w * r;
  Carver w{work + blockIdx.x * per};
  Ctx c = make_ctx(P, r, w);
  float* Yn = w.take(NR);
  float* QY = w.take(NR);
  float* G = w.take(NR);
  float* pg = w.take(NR);
  const float a = alphas[blockIdx.x];
  StepOut o = step_core<D>(c, Y, Ydot, a, 1, Yn, QY, G, pg);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = o.f;
    out[A + blockIdx.x] = o.gradnorm;
    out[2 * A + blockIdx.x] = o.pgradnorm;
  }
}

}  // namespace

extern "C" {

int cora_step(const ChainPlanArgs* P, int r, const float* Y, const float* s,
              int do_retract, float* Yn, float* QY, float* grad, float* scal,
              float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P->d == 2)
    step_kernel<2><<<1, CORA_NTHREADS, 0, st>>>(*P, r, Y, s, do_retract, Yn,
                                                QY, grad, scal, work);
  else
    step_kernel<3><<<1, CORA_NTHREADS, 0, st>>>(*P, r, Y, s, do_retract, Yn,
                                                QY, grad, scal, work);
  return (int)cudaGetLastError();
}

int cora_tcg(const ChainPlanArgs* P, int r, const float* g, const float* Y,
             const float* nF, float delta, int max_iters, float kappa,
             float theta, float* s, float* scal, float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P->d == 2)
    tcg_kernel<2><<<1, CORA_NTHREADS, 0, st>>>(*P, r, g, Y, nF, delta,
                                               max_iters, kappa, theta, s,
                                               scal, work);
  else
    tcg_kernel<3><<<1, CORA_NTHREADS, 0, st>>>(*P, r, g, Y, nF, delta,
                                               max_iters, kappa, theta, s,
                                               scal, work);
  return (int)cudaGetLastError();
}

int cora_chunk(const ChainPlanArgs* P, const TNTArgs* T, int r, float* Y,
               float* G, float* NF, float* fs, int* is, float* hist, int H,
               float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P->d == 2)
    chunk_kernel<2><<<1, CORA_NTHREADS, 0, st>>>(*P, *T, r, Y, G, NF, fs, is,
                                                 hist, H, work);
  else
    chunk_kernel<3><<<1, CORA_NTHREADS, 0, st>>>(*P, *T, r, Y, G, NF, fs, is,
                                                 hist, H, work);
  return (int)cudaGetLastError();
}

int cora_ladder(const ChainPlanArgs* P, int r, const float* Y,
                const float* Ydot, const float* alphas, int A, float* out,
                float* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P->d == 2)
    ladder_kernel<2><<<A, CORA_NTHREADS, 0, st>>>(*P, r, Y, Ydot, alphas, A,
                                                  out, work);
  else
    ladder_kernel<3><<<A, CORA_NTHREADS, 0, st>>>(*P, r, Y, Ydot, alphas, A,
                                                  out, work);
  return (int)cudaGetLastError();
}

}  // extern "C"
