"""`small_eigh`'s test matrices and comparisons, shared by
`scripts/probe_small_eigh.py`, `chip_smoke.py` (phase 2) and
`tests/test_torch_small_eigh.py`, so that a change to the probe changes
neither the smoke test's checks nor the CPU tests' inputs.

    corpus(n, seed)   name → an n × n symmetric float64 matrix (numpy)
    bits_equal(a, b)  two (w, V, info) results with the same bits
    ptxas_lines(log)  (kernel, registers / spills) from nvcc -Xptxas -v
"""

import re

import numpy as np


def corpus(n, seed=0):
    """name → an n × n symmetric float64 matrix (seeded, numpy): random;
    graded Qᵀ diag(λ) Q with λ over 1e-3 … 1e5 and a near-degenerate pair
    at the bottom; a triple and a double eigenvalue; a block and zeros
    elsewhere; random with a NaN in the lower triangle."""
    rng = np.random.default_rng(seed * 1000 + n)
    out = {}
    M = rng.standard_normal((n, n))
    out["random"] = M + M.T
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # graded: eigenvalues 1e-3 … 1e5, the smallest two 1e-7 apart relative
    lam = np.logspace(-3, 5, n)
    lam[1] = lam[0] * (1 + 1e-7)
    G = (Q * lam) @ Q.T
    out["graded"] = 0.5 * (G + G.T)
    # a triple and a double eigenvalue
    lam = np.r_[np.full(3, 2.0), np.full(2, -1.0), rng.uniform(3, 9, n - 5)]
    R = (Q * lam) @ Q.T
    out["repeated"] = 0.5 * (R + R.T)
    Z = np.zeros((n, n))  # a b × b block, zeros elsewhere
    b = min(12, n // 2 + 1)
    B = rng.standard_normal((b, b))
    Z[:b, :b] = B + B.T
    out["zero_block"] = Z
    N = out["random"].copy()
    N[n - 1, 0] = np.nan  # in the lower triangle, which the kernels read
    out["nonfinite"] = N
    return out


def bits_equal(a, b):
    """The same bits in every tensor of two (w, V, info), NaN where NaN."""
    import torch

    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.view(torch.int32 if x.element_size() == 4 else torch.int64),
        y.view(torch.int32 if y.element_size() == 4 else torch.int64))
        for x, y in zip(a, b))


def ptxas_lines(log):
    """(kernel, the registers / spill lines) from `-Xptxas -v` output; a
    small_eigh kernel's name as kernel<type>."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            m = re.search(r"(small_eigh_(?:warp|cta|global|cluster|stream|vectors"
                          r"|sort)_kernel)I(?:([fd])|Li(\d+)E)", name)
            if "small_eigh_vectors_smem_kernel" in name:
                name = "small_eigh_vectors_smem_kernel"
            elif m:
                args = ([{"f": "float", "d": "double"}[m.group(2)]]
                        if m.group(2) else [m.group(3)])
                args += [link for link in ("ClusterLink", "GridLink")
                         if link in name]
                name = f"{m.group(1)}<{', '.join(args)}>"
        elif name and ("registers" in line or "spill" in line):
            out.append((name, line.strip().split(": ", 1)[-1]))
    return out
