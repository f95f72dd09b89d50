"""The host side of the cluster kernels (`chunk`, `tcg`), on the CPU.

The CUDA kernels run only on the card; everything they take from the host
is checked here: the partition tables of `chain.cluster_partition` (who owns
which band block, pose, range and state row), a plain PyTorch emulation of
the partitioned preconditioner solve driven only by those tables, the
rank-ordered cluster sum and `tnt_kernels.work_counts`; and for the
α-batched `ladder`, the split of the trial points over clusters
(`chain.ladder_groups`), its scratch layout (`chain.LadderLayout`) and the
batched banded solve on that layout.

Tolerances: the emulation reorders only the sums of the landmark
right-hand side and the Woodbury products (per CTA, then in rank order), so
in float64 it agrees with `chain.precon_solve` to rounding, 1e-14 relative;
the doubling scan does the same products as `chain._solve_B`; the batched
solve, AB trial points' right-hand sides side by side as AB·r columns of
one band, agrees with `chain.precon_solve` per trial point to the same
1e-14 (the columns never mix). The cluster
sum is held to `torch.sum` at 1e-6 relative in float32 (a 56k-term sum in
another order).
"""

import numpy as np
import pytest
import torch

from cora_tpu_torch.models.synthetic import synthetic_problem
from cora_tpu_torch.ops import chain, tnt_kernels

GRAPHS = {
    "plaza2_shaped": dict(n_poses=4091, n_landmarks=4, n_ranges=1807, dim=2,
                          seed=0),
    "single_drone_shaped": dict(n_poses=1754, n_landmarks=1, n_ranges=1754,
                                dim=3, seed=0),
    # nb = 19 blocks: odd, and divisible by none of the cluster sizes
    "odd_37": dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=2, seed=1),
    # nb = 7 < C: some CTAs own no block
    "small_14": dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=3, seed=3),
}
PARTS = [1, 8, 16]
_PLANS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(name, dtype=np.float64):
    key = (name, np.dtype(dtype).name)
    if key not in _PLANS:
        _PLANS[key] = chain.build_chain_plan(synthetic_problem(**GRAPHS[name]),
                                             dtype=dtype, device="cpu")
    return _PLANS[key]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_partition_covers_everything_once(name, parts):
    plan = _plan(name)
    part = chain.cluster_partition(plan, parts)
    n, m, l, d, nb = plan.n, plan.m, plan.l, plan.d, plan.nb
    blk = part.blk_ptr
    assert blk[0] == 0 and blk[-1] == nb and (np.diff(blk) >= 0).all()
    assert np.diff(blk).max() - np.diff(blk).min() <= 1  # balanced
    poses = np.concatenate([np.arange(*part.poses(c, n)) for c in range(parts)])
    assert np.array_equal(poses, np.arange(n))
    rng_pose = plan.rng_pose.numpy()
    rng_lm = plan.rng_lm.numpy()
    assert np.array_equal(np.sort(part.own_rng), np.arange(m))
    assert np.array_equal(np.sort(part.own_rows), np.arange(plan.N))
    assert np.array_equal(np.sort(part.lmc_rng), np.arange(m))
    for c in range(parts):
        g0, g1 = part.poses(c, n)
        own = part.own_rng[part.rng_ptr[c]:part.rng_ptr[c + 1]]
        # a CTA's ranges are its poses' slot rows, ascending
        assert ((rng_pose[own] >= g0) & (rng_pose[own] < g1)).all()
        assert (np.diff(own) > 0).all()
        slots = plan.slot.numpy()[g0:g1].reshape(-1)
        assert np.array_equal(np.sort(slots[slots >= 0]), own)
        rows = part.own_rows[part.row_ptr[c]:part.row_ptr[c + 1]]
        want = [np.arange(g0 * d, g1 * d), n * d + own,
                np.arange(n * d + m + g0, n * d + m + g1)]
        if c == 0:
            want.append(np.arange(n * d + m + n, plan.N))
        assert np.array_equal(rows, np.concatenate(want))
        for k in range(l):
            t = part.lmc_rng[part.lmc_ptr[c * l + k]:part.lmc_ptr[c * l + k + 1]]
            assert (rng_lm[t] == k).all()
            assert np.array_equal(np.sort(t), own[rng_lm[own] == k])
    if parts == 1:  # one part is the identity: the single-CTA order
        assert np.array_equal(part.own_rows, np.arange(plan.N))
        assert np.array_equal(part.lmc_rng, plan.lm_rng.numpy())
        assert np.array_equal(part.lmc_ptr, plan.lm_ptr.numpy())


def _ranked(partials):
    """Σ of the CTAs' partials in rank order 0..C−1."""
    acc = partials[0]
    for p in partials[1:]:
        acc = acc + p
    return acc


def emulate_precon_solve(plan, part, V):
    """(Q + λI)⁻¹V as the cluster kernel computes it, CTA by CTA: each CTA
    writes only its own band blocks and rows (everything else starts as NaN,
    so a row nobody owns shows), reads block cb ∓ 2ᵏ from the shared band,
    takes propagators only from its propagator slice, and the landmark sums
    are per-CTA partials added in rank order."""
    d, n, nb, w, l, L = plan.d, plan.n, plan.nb, plan.w, plan.l, plan.levels
    r, q, C = V.shape[1], d + 1, part.parts
    nd, tr0 = n * d, n * d + plan.m
    lm0 = tr0 + n
    nan = float("nan")
    own = [(int(part.blk_ptr[c]), int(part.blk_ptr[c + 1])) for c in range(C)]
    sph = V[nd:tr0]
    cw = (plan.cval * plan.spiv_inv)[:, None] * sph
    band = torch.full((nb, w, r), nan, dtype=V.dtype)
    rhs = []
    for c, (b0, b1) in enumerate(own):
        for g in range(2 * b0, 2 * b1):
            blk = band[g // 2, (g % 2) * q:(g % 2) * q + q]
            if g >= n:
                blk.zero_()
                continue
            blk[:d] = V[g * d:(g + 1) * d]
            t = V[tr0 + g].clone()
            for e in plan.slot[g].tolist():
                if e < 0:
                    break
                t += cw[e]
            blk[d] = t
        part_c = torch.zeros((l, r), dtype=V.dtype)
        for k in range(l):
            for e in part.lmc_rng[part.lmc_ptr[c * l + k]:
                                  part.lmc_ptr[c * l + k + 1]]:
                part_c[k] += cw[e]
        rhs.append(part_c)
    src = torch.full_like(band, nan)
    for b0, b1 in own:
        src[b0:b1] = plan.Linv[b0:b1] @ band[b0:b1]
    passes = [(k, False) for k in range(L)] + [(k, True)
                                              for k in reversed(range(L))]
    for k, adj in passes:
        s = 1 << k
        dst = torch.full_like(src, nan)
        for c, (b0, b1) in enumerate(own):
            a, b = part.propagator_slice(c, k, nb, adj)
            A = plan.AF[k, a:b]  # the CTA's slice: block cb at cb − b0
            for cb in range(b0, b1):
                v = src[cb].clone()
                if not adj and cb >= s:
                    v += A[cb - b0] @ src[cb - s]
                if adj and cb < nb - s:
                    v += A[cb - b0].T @ src[cb + s]
                dst[cb] = v
        src = dst
    y1 = torch.full_like(src, nan)
    for b0, b1 in own:
        y1[b0:b1] = plan.Linv[b0:b1].transpose(1, 2) @ src[b0:b1]
    out = torch.full_like(V, nan)
    x_lm = None
    if l:
        wood = [torch.einsum("cek,cer->kr", plan.C[b0:b1], y1[b0:b1])
                for b0, b1 in own]
        lmB = (V[lm0:] - _ranked(rhs)) - _ranked(wood)
        x_lm = plan.capinv @ lmB
        out[lm0:] = x_lm
    for b0, b1 in own:
        x = y1[b0:b1]
        if l:
            x = x - torch.einsum("cek,kr->cer", plan.BinvC[b0:b1], x_lm)
        for i, cb in enumerate(range(b0, b1)):
            for half in range(2):
                g = 2 * cb + half
                if g < n:
                    blk = x[i, half * q:half * q + q]
                    out[g * d:(g + 1) * d] = blk[:d]
                    out[tr0 + g] = blk[d]
    for c in range(C):
        for e in part.own_rng[part.rng_ptr[c]:part.rng_ptr[c + 1]]:
            g, k = int(plan.rng_pose[e]), int(plan.rng_lm[e])
            out[nd + e] = plan.spiv_inv[e] * (
                sph[e] - plan.cval[e] * (x_lm[k] - out[tr0 + g]))
    return src, out


@pytest.mark.parametrize("parts", [1, 3, 8, 16])
@pytest.mark.parametrize("name", ["odd_37", "small_14", "plaza2_shaped"])
def test_partitioned_precon_matches_plain(name, parts):
    plan = _plan(name)
    part = chain.cluster_partition(plan, parts)
    V = torch.as_tensor(np.random.default_rng(parts).standard_normal(
        (plan.N, 4)))
    x_band, x = emulate_precon_solve(plan, part, V)
    ref = chain.precon_solve(plan, V)
    assert torch.isfinite(x).all()
    assert float((x - ref).abs().max() / ref.abs().max()) < 1e-14
    # the scan alone against `_solve_B` on the same right-hand side: the
    # adjoint's output, before Linvᵀ
    rot, sph, tr, _ = chain.split(plan, V)
    band = V.new_zeros((2 * plan.nb, plan.d + 1, 4))
    band[:plan.n, :plan.d] = rot
    band[:plan.n, plan.d] = tr + chain._per_pose(
        plan, (plan.cval * plan.spiv_inv)[:, None] * sph)
    y1 = chain._solve_B(plan, band.view(plan.nb, plan.w, 4))
    y1_emul = plan.Linv.transpose(1, 2) @ x_band
    assert float((y1_emul - y1).abs().max() / y1.abs().max()) < 1e-14


def _warp_tree(x):
    """Lane 0 of `v += __shfl_down_sync(v, o)` for o = 16, 8, 4, 2, 1 over
    each row of 32 lanes."""
    for o in (16, 8, 4, 2, 1):
        x = x[:, :o] + x[:, o:2 * o]
    return x[:, 0]


def cluster_sum(part, x):
    """The kernel's `dot` reduction of the elementwise products x (N·r
    float32, flat): in each CTA of 1024 threads, thread t sums its own
    elements t, t + 1024, … in order; a shuffle-down tree sums each warp and
    warp 0 the 32 warp partials; then the CTAs' partials are added in rank
    order."""
    r = x.numel() // len(part.own_rows)
    partials = []
    for c in range(part.parts):
        rows = torch.as_tensor(
            part.own_rows[part.row_ptr[c]:part.row_ptr[c + 1]], dtype=torch.int64)
        v = x[(rows[:, None] * r + torch.arange(r)).reshape(-1)]
        per = torch.zeros(-(-v.numel() // 1024) * 1024, dtype=x.dtype)
        per[:v.numel()] = v
        acc = torch.zeros(1024, dtype=x.dtype)
        for row in per.view(-1, 1024):
            acc = acc + row
        warps = _warp_tree(acc.view(32, 32))
        partials.append(_warp_tree(warps.view(1, 32))[0])
    return _ranked(partials)


@pytest.mark.parametrize("parts", PARTS)
def test_cluster_sum_is_fixed_order(parts):
    plan = _plan("plaza2_shaped")
    part = chain.cluster_partition(plan, parts)
    A = torch.as_tensor(np.random.default_rng(7).standard_normal(plan.N * 4),
                        dtype=torch.float32)
    s1, s2 = cluster_sum(part, A * A), cluster_sum(part, A * A)
    assert s1.view(torch.int32) == s2.view(torch.int32)
    ref = (A * A).sum()
    assert abs(float(s1) - float(ref)) <= 1e-6 * float(ref)


def test_work_counts_hand_count():
    # 3 poses in 2 dimensions: nb = 2 blocks of width 6, 1 scan level; one
    # landmark with 2 ranges (slots S = 1 or 2)
    problem = synthetic_problem(n_poses=3, n_landmarks=1, n_ranges=2, dim=2,
                                seed=0)
    plan = chain.build_chain_plan(problem, dtype=np.float32, device="cpu")
    n, m, l, N, nb, w, S, L = 3, 2, 1, 3 * 2 + 2 + 3 + 1, 2, 6, plan.S, 1
    assert (plan.n, plan.m, plan.l, plan.N, plan.nb, plan.w, plan.levels) \
        == (n, m, l, N, nb, w, L)
    r = 3
    wc = tnt_kernels.work_counts(plan, r, tcg_iters=5, kernel="tcg")
    # per tCG iteration: hvp (Q·Ẏ's entry barrier + its landmark sum), the
    # dot ⟨d, Hd⟩, the preconditioner (1 forward + 1 adjoint level + the
    # Woodbury sum), the dot ⟨r, z⟩
    assert wc["phases_per_tcg"] == 2 + 1 + 3 + 1
    # tcg: the first preconditioner solve (3) + ⟨g, z⟩ + ‖s‖ + exit barrier
    assert wc["phases"] == 3 + 1 + 1 + 1 + 5 * 7
    plan_words = (n * (1 + 4 + 1 + 2)  # kap, R, tau, tvec
                  + n * S + 2 * m + (l + 1) + m  # slot, range/landmark tables
                  + 4 * m  # rr, om, spiv, cval
                  + nb * w * w * 2  # Linv, one propagator level
                  + 2 * l * nb * w + l * l + 24  # Ct, BinvCt, capinv, qdwh
                  + 3 * 2 + N + m + 1 * l + 1 + m)  # partition of one part
    assert wc["bytes"] == 4 * (plan_words + 3 * N * r + N * r + 4)
    st = tnt_kernels.work_counts(plan, r, 0, kernel="step")
    # Q·Y (2) + ⟨Y, QY⟩ + ‖grad‖ + ⟨g, Pg⟩ + the preconditioner (3) + the
    # exit barrier
    assert st["phases"] == 2 + 3 + 3 + 1
    assert st["bytes"] == 4 * (plan_words + 5 * N * r + 3)
    ch = tnt_kernels.work_counts(plan, r, tcg_iters=5, kernel="chunk",
                                 outer_iters=2, init=True)
    # scalar read + exit barriers, the init step, 5 tCG iterations, and per
    # outer iteration the tCG's fixed 5, the trial step's 8, the history
    assert ch["phases"] == 2 + 8 + 5 * 7 + 2 * (5 + 8 + 1)
    assert ch["bytes"] == 4 * (plan_words + 6 * N * r + 20 + 5 * 2 + 9)



def _plan_words(plan, parts):
    n, m, l, N, nb, w, S, L = (plan.n, plan.m, plan.l, plan.N, plan.nb,
                               plan.w, plan.S, plan.levels)
    d = plan.d
    return (n * (1 + d * d + 1 + d)  # kap, R, tau, tvec
            + n * S + 2 * m + (l + 1) + m  # slot, range/landmark tables
            + 4 * m  # rr, om, spiv, cval
            + nb * w * w * (1 + L)  # Linv, the propagator levels
            + 2 * l * nb * w + l * l + 24  # Ct, BinvCt, capinv, qdwh
            + 3 * (parts + 1) + N + m + parts * l + 1 + m)  # partition


def test_work_counts_step_ladder_parts():
    problem = synthetic_problem(n_poses=3, n_landmarks=1, n_ranges=2, dim=2,
                                seed=0)
    plan = chain.build_chain_plan(problem, dtype=np.float32, device="cpu")
    nb, w, L, N, r, parts = 2, 6, 1, 12, 3, 16
    assert (plan.nb, plan.w, plan.levels, plan.N) == (nb, w, L, N)
    words = _plan_words(plan, parts)
    st = tnt_kernels.work_counts(plan, r, 0, kernel="step", parts=parts)
    # Q·Y (2), three dots, the preconditioner (1 + 1 levels + Woodbury),
    # the exit barrier: every one spans the 16 CTAs
    assert st["phases"] == 2 + 3 + 3 + 1
    # Y and s in; Yn, QY, grad out; three scalars
    assert st["bytes"] == 4 * (words + 5 * N * r + 3)
    one = tnt_kernels.work_counts(plan, r, 0, kernel="ladder", alphas=6,
                                  parts=parts)
    lad = tnt_kernels.work_counts(plan, r, 0, kernel="ladder", alphas=6,
                                  parts=parts, clusters=3)
    # the trial points run side by side: one step's phases, at any K
    assert one["phases"] == lad["phases"] == st["phases"]
    # Y and Ẏ, 6 α in and 3 × 6 scalars out, the group table (K + 1
    # int32) and the band offsets (K + 1 int64), and Linv and the
    # propagators once more for each cluster past the first
    assert one["bytes"] == 4 * (words + 2 * N * r + 4 * 6) + 12 * 2
    assert lad["bytes"] == 4 * (words + 2 * nb * w * w * (1 + L)
                                + 2 * N * r + 4 * 6) + 12 * 4
    assert lad["flops"] == one["flops"] == 6 * st["flops"]


@pytest.mark.parametrize("K", [1, 3, 8, 48])
@pytest.mark.parametrize("A", [2, 48])
def test_ladder_groups_cover_every_alpha_once(A, K):
    grp = chain.ladder_groups(A, K)
    assert grp.dtype == np.int32 and len(grp) == K + 1
    assert grp[0] == 0 and grp[-1] == A
    sizes = np.diff(grp)
    assert (sizes >= 0).all() and sizes.max() - sizes.min() <= 1  # balanced
    # contiguous groups: concatenated, they list every α once, in order
    alphas = np.concatenate([np.arange(grp[k], grp[k + 1]) for k in range(K)])
    assert np.array_equal(alphas, np.arange(A))
    if K <= A:
        assert sizes.min() >= 1  # no idle cluster


@pytest.mark.parametrize("parts", [1, 3, 8, 16])
@pytest.mark.parametrize("name", ["odd_37", "small_14"])
def test_batched_precon_on_ladder_layout(name, parts):
    """The α-batched ladder's preconditioner solve, on the scratch as
    `chain.LadderLayout` lays it out: A = 5 trial points at r = 3 over
    K = 2 clusters (groups of 2 and 3: 6 and 9 columns, padded to 8 and
    12). Each trial point's right-hand side sits in its own grad state;
    each cluster's band holds its group's right-hand sides side by side
    (trial point al in columns al·r .. al·r + r) and goes through ONE
    partitioned solve (`emulate_precon_solve` on those columns); each
    trial point's solution lands in its own QY state. Every region is
    written once (the scratch starts as NaN and each write checks it was
    untouched), and each trial point's solution equals `chain.precon_solve`
    on its own right-hand side to 1e-14 (float64)."""
    plan = _plan(name)
    part = chain.cluster_partition(plan, parts)
    r, A, K = 3, 5, 2
    N, NR, nb, w = plan.N, plan.N * r, plan.nb, plan.w
    grp = chain.ladder_groups(A, K)
    lay = chain.ladder_layout(plan, r, grp)
    assert lay.state_stride == 3 * NR
    assert [lay.cols(k) for k in range(K)] == [8, 12]
    off = lay.band_off
    assert off.dtype == np.int64 and (off % 4 == 0).all()
    assert off[0] >= A * lay.state_stride and lay.total == off[-1]
    work = torch.full((lay.total,), float("nan"), dtype=torch.float64)

    def region(at, count):
        view = work[at:at + count]
        assert view.numel() == count and torch.isnan(view).all()
        return view

    rng = np.random.default_rng(10 + parts)
    Vs = [torch.as_tensor(rng.standard_normal((N, r))) for _ in range(A)]
    for a in range(A):
        region(lay.state(a) + 2 * NR, NR).copy_(Vs[a].reshape(-1))
    for k in range(K):
        a0, AB = int(grp[k]), int(grp[k + 1] - grp[k])
        grads = [work[lay.state(a) + 2 * NR:lay.state(a) + 3 * NR].view(N, r)
                 for a in range(a0, a0 + AB)]
        x_band, x = emulate_precon_solve(plan, part, torch.cat(grads, dim=1))
        assert 2 * lay.band_len(k) == off[k + 1] - off[k]
        band0 = region(int(off[k]), lay.band_len(k)).view(nb, w, lay.cols(k))
        band1 = region(int(off[k]) + lay.band_len(k), lay.band_len(k))
        band0[:, :, :AB * r] = x_band
        band1.zero_()
        for al in range(AB):
            out = region(lay.state(a0 + al) + NR, NR)
            out.copy_(x[:, al * r:(al + 1) * r].reshape(-1))
            # the band's columns al·r .. al·r + r are this trial point's
            single, _ = emulate_precon_solve(plan, part, Vs[a0 + al])
            col = band0[:, :, al * r:(al + 1) * r]
            assert float((col - single).abs().max()
                         / single.abs().max()) < 1e-14
        # the padding columns are nobody's
        assert torch.isnan(band0[:, :, AB * r:]).all()
    for a in range(A):
        x = work[lay.state(a) + NR:lay.state(a) + 2 * NR].view(N, r)
        ref = chain.precon_solve(plan, Vs[a])
        assert float((x - ref).abs().max() / ref.abs().max()) < 1e-14


@pytest.mark.parametrize("entry", ["build_chain_plan", "get_chain_plan",
                                   "polish_solution"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, each entry point asks for the card and,
    with none there, raises before any work; `device="cpu"` runs here."""
    from cora_tpu_torch.solve.polish import polish_solution
    from cora_tpu_torch.solve.tnt_kernel import get_chain_plan

    fn = {"build_chain_plan": chain.build_chain_plan,
          "get_chain_plan": get_chain_plan,
          "polish_solution": polish_solution}[entry]
    problem = synthetic_problem(**GRAPHS["small_14"])
    args = (problem,) if entry != "polish_solution" else (
        problem, np.zeros((problem.data_matrix_size, 3)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)
    if entry != "polish_solution":
        assert fn(*args, device="cpu").device.type == "cpu"
