#!/usr/bin/env python3
"""Time the cluster `tcg` kernel's loop pass by pass on one NVIDIA GPU.

    python3 scripts/probe_tcg_split.py [CSRC ...]

For each CSRC directory (default: this tree's `cora_tpu_torch/ops/csrc/`;
another version's `chain_ops.cuh` and `tnt_kernels.cu`, e.g. a parent
commit's unpacked with `git archive` into a directory `.gitignore` lists),
writes a copy of the sources into `.torch_ext_build/tcg_split_<i>/` with a
`clock64()` mark at each pass boundary of `tcg_core`'s loop and of
`precon_solve` (thread 0 of CTA 0 adds the cycles since its last mark to
a `__device__` table), builds it with the package's nvcc flags and runs
the long tCG case of `chip_smoke.py` (∇F = 0, Δ = 1e8: tens of
iterations) ten times on the plaza2-shaped graph at rank 4 and the
single_drone-shaped graph at rank 5, the builds in turns, twice. Prints
µs per tCG iteration and, per pass, µs per iteration (cycles over the
clock rate those ten calls ran at). A mark whose source line a version
lacks is left out; its time falls into the next mark. CTA 0's view: a
pass ended by a cluster barrier includes the wait for the slowest CTA.
Only the launch entry points come from the instrumented library, so their
C signatures, and the plan struct's layout up to this tree's, must match
this tree's.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = [("plaza2", dict(n_poses=4091, n_landmarks=4, n_ranges=1807, dim=2,
                          seed=0), 4),
          ("drone", dict(n_poses=1754, n_landmarks=1, n_ranges=1754, dim=3,
                         seed=0), 5)]
MARK = '''
__device__ unsigned long long cora_split[48];
__device__ long long cora_last;
__device__ __forceinline__ void cora_mark(int k) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const long long t = clock64();
    if (k >= 0) cora_split[k] += (unsigned long long)(t - cora_last);
    cora_last = t;
  }
}
'''
READ = '''
extern "C" int cora_split_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, cora_split, sizeof(cora_split));
}
extern "C" int cora_split_reset() {
  unsigned long long z[48] = {0};
  return (int)cudaMemcpyToSymbol(cora_split, z, sizeof(z));
}
'''
# (mark, where: "before"/"after" the first line starting with the text,
# inside precon_solve or the tCG loop); a mark ends the pass named
PRECON = [(10, "before", "  // 2) u = Linv", "band rhs"),
          (11, "before", "  // 3) the scan over", "Linv"),
          (12, "before", "    G::sync();  // every CTA's end block",
           "forward levels"),
          (13, "after", "    carry_in<D", "barrier 1 + carry in"),
          (14, "before", "    carry_sum<D", "fix-up"),
          (15, "after", "    G::sync();  // every CTA's sum",
           "carry sum + barrier 2"),
          (16, "after", "    carry_out<D", "carry out"),
          (17, "before", "  // 4) y1 = Linv", "adjoint levels"),
          (18, "after", "  const float* y1 = src;", "Linv^T"),
          (19, "before", "  // 6) sphere back", "Woodbury + scatter")]
TURN = "    tangent_project<D, G>(c, Y, z, z);\n    const float rz_new"
LOOP = [("  precon_solve<D, G>(c, g, z);\n", "  cora_mark(-1);\n", ""),
        ("    hvp<D, G>(c, Y, nF, dv, Hd);\n", "    cora_mark(-1);\n",
         "    cora_mark(1);\n"),
        ("    const float dHd = dot<G>(c, dv, Hd);\n", "",
         "    cora_mark(2);\n"),
        ("    precon_solve<D, G>(c, rv, z);\n", "    cora_mark(3);\n",
         "    cora_mark(20);\n"),
        ("    const float rz_new = dot<G>(c, rv, z);\n", "",
         "    cora_mark(5);\n"),
        ("    k += 1;\n", "", "    cora_mark(6);\n")]
NAMES = {1: "hvp", 2: "<d, Hd>", 3: "s, r update", 4: "projection",
         5: "<r, z>", 6: "d update", 20: "sphere back",
         **{k: name for k, _, _, name in PRECON}}


def instrument(src_dir, dst_dir):
    """The sources of src_dir with the marks, in dst_dir."""
    os.makedirs(dst_dir, exist_ok=True)
    s = open(os.path.join(src_dir, "chain_ops.cuh")).read()
    s = s.replace("namespace cg = cooperative_groups;\n",
                  "namespace cg = cooperative_groups;\n" + MARK, 1)
    i0 = s.index("__device__ void precon_solve(Ctx& c")
    head, body = s[:i0], s[i0:]
    for k, where, text, _ in PRECON:
        m = re.search("^" + re.escape(text) + ".*\n", body, re.M)
        if m:
            at = m.start() if where == "before" else m.end()
            body = body[:at] + f"  cora_mark({k});\n" + body[at:]
    s = head + body
    for text, before, after in LOOP:
        s = s.replace(text, before + text + after, 1)
    s = s.replace(TURN, TURN.replace("\n", "\n    cora_mark(4);\n", 1), 1)
    open(os.path.join(dst_dir, "chain_ops.cuh"), "w").write(s)
    t = open(os.path.join(src_dir, "tnt_kernels.cu")).read() + READ
    open(os.path.join(dst_dir, "tnt_kernels.cu"), "w").write(t)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_tcg_split: no CUDA device available")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.ops.riemannian import random_initial_guess
    from cora_tpu_torch.ops.tnt_kernels import CudaTNT, PlainTNT
    from cora_tpu_torch.solve.tnt import HashableParams
    from cora_tpu_torch.solve.tnt_kernel import get_chain_plan
    from cora_tpu_torch.types import TNTParams

    dirs = sys.argv[1:] or [str(tnt_kernels.CSRC)]
    print(chip_smoke.card_line(), flush=True)
    builds = {}
    for i, d in enumerate(dirs):  # nvcc in parallel
        out = os.path.join(tnt_kernels.BUILD_DIR, f"tcg_split_{i}")
        instrument(d, out)
        so = os.path.join(out, "lib.so")
        builds[d] = (so, subprocess.Popen(
            [tnt_kernels._nvcc(), *tnt_kernels.NVCC_FLAGS, "-o", so,
             os.path.join(out, "tnt_kernels.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    this = tnt_kernels.load_library()
    libs = {}
    for d, (so, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {d}:\n{log}")
        lib = ctypes.CDLL(so)
        ns = {k: getattr(this, k) for k in dir(this) if k.startswith("cora_")}
        for k in ("cora_chunk", "cora_tcg", "cora_step"):
            fn, ref = getattr(lib, k), getattr(this, k)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            ns[k] = fn
        ns["get"], ns["reset"] = lib.cora_split_get, lib.cora_split_reset
        libs[d] = type("Split", (), ns)()
    hp = HashableParams(TNTParams())
    for gname, graph, rank in GRAPHS:
        problem = synthetic_problem(**graph)
        plan = get_chain_plan(problem, np.float32, "cuda")
        pd = problem.device_data(np.float32, "cuda")
        gen = torch.Generator().manual_seed(100 + rank)
        Y = random_initial_guess(pd, rank, gen).contiguous()
        V = (0.1 * torch.randn(Y.shape, generator=gen, dtype=torch.float64)
             ).to(Y).contiguous()
        _, _, G, _ = PlainTNT(plan, hp).step(Y, V, False)
        nF = torch.zeros_like(G)
        for turn in range(2):
            for d, lib in libs.items():
                kern = CudaTNT(plan, hp)
                kern.lib = lib
                kern.tcg(G, Y, nF, 1e8, 80)
                torch.cuda.synchronize()
                lib.reset()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                its = 0.0
                t0.record()
                for _ in range(10):
                    its += float(kern.tcg(G, Y, nF, 1e8, 80)[1][2])
                t1.record()
                torch.cuda.synchronize()
                ms = t0.elapsed_time(t1)
                buf = (ctypes.c_ulonglong * 48)()
                lib.get(buf)
                cyc = np.array(buf[:], dtype=np.float64)
                rate = cyc.sum() / (1e3 * ms)  # cycles per µs
                parts = ", ".join(f"{NAMES[k]} {cyc[k] / its / rate:.2f}"
                                  for k in sorted(NAMES) if cyc[k])
                print(f"[split] {gname} r={rank} {d} turn {turn}: "
                      f"{1e3 * ms / its:.2f} us per tCG iteration "
                      f"({its / 10:.0f} its, {rate:.0f} cycles/us); per "
                      f"iteration, us: {parts}", flush=True)


if __name__ == "__main__":
    main()
