#!/usr/bin/env python3
"""Hold the cluster `chunk`, `tcg` and `ladder` of this tree's CUDA sources
against another build of them, on one card: same bits, and times in turns.

    python3 scripts/compare_kernel_builds.py OTHER_CSRC

OTHER_CSRC is a directory holding another version's `chain_ops.cuh` and
`tnt_kernels.cu` (for example `cora_tpu_torch/ops/csrc/` of a parent
commit, unpacked with `git archive` into a directory `.gitignore` lists).
Both are built with the same nvcc flags. On the plaza2-shaped graph
(rank 4) and the single_drone-shaped graph (rank 5), from chip_smoke.py's
start, the script runs `chunk` (the start's evaluation + 8 TNT iterations)
and `tcg` (∇F = 0, Δ = 1e8: tens of iterations) with each library, says
whether every output is bit-equal, and times each in turns (other, this,
this, other; median of 20, CUDA events). The α-batched `ladder` (48 trial
points at the default cluster count) must give the other library's bits,
and this tree's must give the same bits five times at one cluster and at
every cluster count the card holds. Only the launch entry points come
from the other library (its C interface for them is this tree's); the
capacity queries are this tree's. Exits non-zero on any difference.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = [(dict(n_poses=4091, n_landmarks=4, n_ranges=1807, dim=2, seed=0), 4),
          (dict(n_poses=1754, n_landmarks=1, n_ranges=1754, dim=3, seed=0), 5)]


LAUNCHERS = ("cora_chunk", "cora_tcg", "cora_ladder")


def build_other(csrc, tnt_kernels):
    """The other sources' library, built like this tree's: this tree's
    library with the other's launch entry points (`LAUNCHERS`)."""
    os.makedirs(tnt_kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(tnt_kernels.BUILD_DIR, "other_kernels.so")
    proc = subprocess.run([tnt_kernels._nvcc(), *tnt_kernels.NVCC_FLAGS, "-o",
                           so, os.path.join(csrc, "tnt_kernels.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}:\n{proc.stdout}{proc.stderr}")
    other = ctypes.CDLL(so)
    this = tnt_kernels.load_library()
    types = {}
    for name in LAUNCHERS:
        fn, ref = getattr(other, name), getattr(this, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        types[name] = fn
    lib = type("OtherLibrary", (), {})()
    for name in dir(this):
        if name.startswith("cora_"):
            setattr(lib, name, types.get(name, getattr(this, name)))
    return lib


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernel_builds: no CUDA device available")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    import chip_smoke
    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.ops.riemannian import random_initial_guess
    from cora_tpu_torch.ops.tnt_kernels import CudaTNT
    from cora_tpu_torch.solve.tnt import HashableParams
    from cora_tpu_torch.solve.tnt_kernel import get_chain_plan
    from cora_tpu_torch.types import TNTParams

    tnt_kernels.load_library()
    other_lib = build_other(sys.argv[1], tnt_kernels)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    hp = HashableParams(TNTParams())
    ok = True
    for ci, (graph, rank) in enumerate(GRAPHS):
        problem = synthetic_problem(**graph)
        plan = get_chain_plan(problem, np.float32, "cuda")
        this = CudaTNT(plan, hp)
        other = CudaTNT(plan, hp)
        other.lib = other_lib
        pd = problem.device_data(np.float32, "cuda")
        gen = torch.Generator().manual_seed(100 + 2 * ci)
        Y = random_initial_guess(pd, rank, gen).contiguous()
        V = (0.1 * torch.randn(Y.shape, generator=gen, dtype=torch.float64)
             ).to(Y).contiguous()

        def chunk_args():
            fs = torch.tensor([0, 0, 0, 5.0, float("inf"), 1e-4, 0, 0],
                              dtype=torch.float32, device="cuda")
            isc = torch.tensor([0, 0, 0, 0, 0, 8, 80, 60, 24, 10, 1, 0],
                               dtype=torch.int32, device="cuda")
            hist = torch.zeros((5, 80), dtype=torch.float32, device="cuda")
            return (Y.clone(), torch.zeros_like(Y), torch.zeros_like(Y), fs,
                    isc, hist)

        a, b = chunk_args(), chunk_args()
        this.chunk(*a)
        other.chunk(*b)
        same_chunk = all(torch.equal(x, y) for x, y in zip(a, b))
        _, _, G, _ = this.step(Y, V, False)
        nF = torch.zeros_like(G)
        same_tcg = all(torch.equal(x, y) for x, y in zip(
            this.tcg(G, Y, nF, 1e8, 80), other.tcg(G, Y, nF, 1e8, 80)))
        t_chunk = [chip_smoke.median_ms(lambda *x, k=k: k.chunk(*x), torch,
                                        chunk_args)
                   for k in (other, this, this, other)]
        t_tcg = [chip_smoke.median_ms(
            lambda k=k: k.tcg(G, Y, nF, 1e8, 80), torch)
            for k in (other, this, this, other)]
        al = 4.0 * 0.5 ** np.arange(24)
        al = torch.tensor(np.stack([al, -al], 1).reshape(-1),
                          dtype=torch.float32)
        cap = this.ladder_capacity(rank)
        outs = [this.ladder(Y, V, al, clusters=1) for _ in range(5)]
        outs += [this.ladder(Y, V, al, clusters=k) for k in range(2, cap + 1)]
        same_ladder = all(torch.equal(o, outs[0]) for o in outs)
        same_other = torch.equal(this.ladder(Y, V, al), other.ladder(Y, V, al))
        t_ladder = [chip_smoke.median_ms(lambda k=k: k.ladder(Y, V, al), torch)
                    for k in (other, this, this, other)]
        name = f"d={graph['dim']} n={graph['n_poses']} r={rank}"
        print(f"[compare] {name}: chunk bit-equal {same_chunk}, tcg "
              f"bit-equal {same_tcg}; chunk ms (other, this, this, other) "
              + ", ".join(f"{t:.4f}" for t in t_chunk) + "; tcg ms "
              + ", ".join(f"{t:.4f}" for t in t_tcg)
              + f"; ladder bit-equal to the other's {same_other}, ms "
              + ", ".join(f"{t:.4f}" for t in t_ladder)
              + f"; ladder bit-equal over 5 runs at K = 1 and K = 2.."
              f"{cap}: {same_ladder}", flush=True)
        ok = ok and same_chunk and same_tcg and same_ladder and same_other
    if not ok:
        raise SystemExit("compare_kernel_builds: results differ")


if __name__ == "__main__":
    main()
