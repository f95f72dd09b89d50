"""The certificate's LOBPCG, the f64 polish's Newton-CG and the batched
saddle escape of the port as device loops, on the CPU (the plain twin of
`small_eigh`, every loop eager), against the JAX package.

  * `small_eigh`'s plain twin against `numpy.linalg.eigh`: eigenvalues to
    1e-12 (float64) / 1e-5 (float32) of the largest, the sign rule (each
    eigenvector's largest-magnitude entry positive), the eigenvectors
    themselves where the spectrum is simple (1e-10 / 1e-4) and AV = VΛ,
    VᵀV = I (1e-12 / 1e-5) on a zero block and a repeated eigenvalue;
    batched matrices, and NaN eigenpairs for a non-finite matrix;
  * `lobpcg_min` at LOBPCG blocks of 1, 3 and 64 ends on the same bits, and
    against JAX's `lobpcg_min` on the same operator and start: θ₀ to 1e-8
    relative in float64 and 1e-4 in float32, the iteration count within
    ±2, |⟨x, x_jax⟩| ≥ 1 − 1e-6 (the spectral gap is large);
  * `_cert_eig_device` (both stages) against JAX's, with the banded factor
    of S + σI and with the Jacobi diagonal as the stage-2 preconditioner:
    θ to 1e-6 relative, iterations within ±2, |⟨x, x_jax⟩| ≥ 1 − 1e-4, the
    tolerances of `tests/test_torch_certify.py`;
  * `newton_step` against the JAX polish's jitted one
    (`_jax_polish_kernels`) in float64, at a point 20 TNT iterations from
    a start: f and ‖grad‖ to 1e-12, s to 1e-10, ⟨grad, s⟩ to 1e-10, CG
    iterations equal; at CG blocks of 1, 3 and 64 on the same bits;
    `polish_solution` against JAX's from the JAX package's near-critical
    TNT solution: f to 1e-10, status and iterations equal;
  * the batched escape ladder against JAX's `_trial_ladder` in float64 at
    a rank-d saddle and its certificate's eigenvector (f, ‖grad‖,
    ‖Proj(P grad)‖ per signed α to 1e-10) and `saddle_escape`'s state to
    1e-10, which is the same accepted α;
  * each loop's step functions run with `Tensor.__bool__`, `.item`,
    `.tolist`, `.cpu`, `.numpy` and the number conversions patched to
    raise, which is what lets them be captured as CUDA graphs.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu.io.pyfg import parse_pyfg_python as jax_parse  # noqa: E402
from cora_tpu.models.synthetic import synthetic_problem as jax_synthetic  # noqa: E402
from cora_tpu.ops import riemannian as jr  # noqa: E402
from cora_tpu.ops.lobpcg import lobpcg_min as jax_lobpcg  # noqa: E402
from cora_tpu.precond.banded import device_factor as jax_device_factor  # noqa: E402
from cora_tpu.precond.banded import factor_banded as jax_factor_banded  # noqa: E402
from cora_tpu.solve import certify as jax_cert  # noqa: E402
from cora_tpu.solve import saddle as jax_saddle  # noqa: E402
from cora_tpu.solve.polish import _jax_polish_kernels  # noqa: E402
from cora_tpu.solve.polish import polish_solution as jax_polish  # noqa: E402
from cora_tpu.solve.tnt import _normalize_precon  # noqa: E402
from cora_tpu.solve.tnt import tnt_solve as jax_tnt  # noqa: E402
from cora_tpu.solve.verification import certificate_matrix_host as jax_smat  # noqa: E402
from cora_tpu.types import Preconditioner as JaxPrecond  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import lobpcg  # noqa: E402
from cora_tpu_torch.ops.riemannian import project_to_manifold  # noqa: E402
from cora_tpu_torch.ops.small_eigh import small_eigh  # noqa: E402
from cora_tpu_torch.precond.banded import device_factor, factor_banded  # noqa: E402
from cora_tpu_torch.solve import certify, polish, saddle  # noqa: E402
from cora_tpu_torch.solve.verification import certificate_matrix_host  # noqa: E402
from cora_tpu_torch.types import Preconditioner  # noqa: E402
from cora_tpu_torch.utils.graphs import device_loop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

MULTI = dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
             n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2, dim=2,
             seed=0)
CHAIN3 = dict(n_poses=30, n_landmarks=2, n_ranges=20, dim=3, seed=2)
EIG_TOL = {np.float64: 1e-12, np.float32: 1e-5}
VEC_TOL = {np.float64: 1e-10, np.float32: 1e-4}
THETA_TOL = {np.float64: 1e-8, np.float32: 1e-4}
BLOCKS = (1, 3, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name → (JAX problem, port problem)."""
    path = tmp_path_factory.mktemp("pyfg") / "multi.pyfg"
    path.write_text(multi_robot_pyfg(**MULTI))
    return {"multi_2d": (jax_parse(str(path)), parse_pyfg(str(path))),
            "chain_3d": (jax_synthetic(**CHAIN3), synthetic_problem(**CHAIN3))}


def _same_bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# small_eigh's plain twin


def _matrix(case, rng):
    if case in ("random30", "random31"):
        M = rng.standard_normal((int(case[-2:]),) * 2)
        return M + M.T
    Q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    if case == "repeated":  # a triple and a double eigenvalue
        lam = np.r_[np.full(3, 2.0), np.full(2, -1.0), rng.uniform(3, 9, 25)]
        M = (Q * lam) @ Q.T
        return 0.5 * (M + M.T)
    M = np.zeros((30, 30))  # "zero_block": a 12 × 12 block, zeros elsewhere
    B = rng.standard_normal((12, 12))
    M[:12, :12] = B + B.T
    return M


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["random30", "random31", "zero_block",
                                  "repeated"])
def test_small_eigh_plain_matches_numpy(case, dtype):
    M = _matrix(case, np.random.default_rng(len(case)))
    w, V, info = small_eigh(torch.as_tensor(M.astype(dtype)))
    assert w.dtype == V.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert int(info) == 0
    w, V = w.double().numpy(), V.double().numpy()
    ref_w, ref_V = np.linalg.eigh(M)
    scale = max(np.abs(ref_w).max(), 1.0)
    assert np.abs(w - ref_w).max() <= EIG_TOL[dtype] * scale
    # the sign rule: the first entry of largest magnitude is positive
    at = np.abs(V).argmax(axis=0)
    assert (V[at, np.arange(V.shape[1])] > 0).all()
    if case.startswith("random"):  # a simple spectrum: the vectors agree
        at = np.abs(ref_V).argmax(axis=0)
        ref_V = ref_V * np.sign(ref_V[at, np.arange(ref_V.shape[1])])
        assert np.abs(V - ref_V).max() <= VEC_TOL[dtype]
    tol = 10 * EIG_TOL[dtype]
    assert np.abs(M @ V - V * w).max() <= tol * scale
    assert np.abs(V.T @ V - np.eye(len(w))).max() <= tol


def test_small_eigh_plain_batched_and_nonfinite():
    rng = np.random.default_rng(0)
    Ms = np.stack([_matrix("random30", rng) for _ in range(3)])
    Ms[1, 4, 7] = np.nan  # the second matrix is not finite
    w, V, info = small_eigh(torch.as_tensor(Ms))
    assert w.shape == (3, 30) and V.shape == (3, 30, 30)
    assert info.shape == (3,) and not info.any()
    assert torch.isnan(w[1]).all() and torch.isnan(V[1]).all()
    for b in (0, 2):
        w1, V1, _ = small_eigh(torch.as_tensor(Ms[b]))
        assert torch.allclose(w[b], w1, rtol=0, atol=1e-13)
        assert torch.allclose(V[b], V1, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the LOBPCG loop


def _operator(n, dtype):
    """A symmetric matrix with λ₀ = −3 well apart from λ₁ = 1 … 10, its
    SPD Jacobi-like preconditioner and a start block, in `dtype`."""
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.r_[-3.0, np.linspace(1.0, 10.0, n - 1)]
    A = ((Q * lam) @ Q.T).astype(dtype)
    d = np.abs(np.diag(A)) + 1.0
    X0 = rng.standard_normal((n, 6)).astype(dtype)
    return A, (1.0 / d).astype(dtype), X0, Q[:, 0]


VARIANTS = {"plain": {}, "precon": {"precon": True},
            "early": {"early_stop_below": -1.0}}


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lobpcg_blocks_same_bits_and_match_jax(variant, dtype):
    A, dinv, X0, x_true = _operator(120, dtype)
    kw = dict(VARIANTS[variant])
    At, dt_ = torch.as_tensor(A), torch.as_tensor(dinv)[:, None]
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)[:, None]
    pt = (lambda V: dt_ * V) if kw.pop("precon", False) else None
    pj = (lambda V: dj * V) if pt is not None else None
    runs = []
    for block in BLOCKS:
        with device_loop(lobpcg_block=block):
            runs.append(lobpcg.lobpcg_min(lambda V: At @ V,
                                          torch.as_tensor(X0), 60, tol=1e-6,
                                          precon=pt, **kw))
    for theta, X, it, n_conv in runs[1:]:
        assert _same_bits(theta, runs[0][0]) and _same_bits(X, runs[0][1])
        assert (it, n_conv) == runs[0][2:]
    theta, X, it, _ = runs[0]
    ref_theta, ref_X, ref_it, _ = jax_lobpcg(
        lambda V: Aj @ V, jnp.asarray(X0), 60, tol=1e-6, precon=pj, **kw)
    assert abs(float(theta[0]) - float(ref_theta[0])) <= \
        THETA_TOL[dtype] * abs(float(ref_theta[0]))
    assert abs(it - int(ref_it)) <= 2
    x, xj = X[:, 0].double().numpy(), np.asarray(ref_X[:, 0], np.float64)
    assert abs(x @ xj) / (np.linalg.norm(x) * np.linalg.norm(xj)) >= 1 - 1e-6
    if variant == "early":  # stops once θ₀ < −1, before convergence
        assert it < 60 and float(theta[0]) < -1.0
    else:
        assert abs(abs(x @ x_true) / np.linalg.norm(x) - 1) <= 1e-6


# ---------------------------------------------------------------------------
# the certificate's two stages


def _not_psd_point(jp, tp, rank=3, seed=4):
    jpd = jp.device_data(dtype=np.float64)
    A = np.random.default_rng(seed).uniform(-1.0, 1.0, (jpd.size, rank))
    return np.asarray(jr.project_to_manifold(jpd, jnp.asarray(A)))


def _factors(jp, tp, Y, sigma=1.0):
    """The banded factors of S + σI of both packages (σ ×16 until both
    factor)."""
    jpd = jp.device_data(dtype=np.float64)
    pd_host = tp.device_data(np.float64, "cpu")
    Sj = jax_smat(jpd, jp.data_matrix(), Y)
    St = certificate_matrix_host(pd_host, tp.data_matrix(), Y)
    for _ in range(12):
        try:
            Fj = jax_factor_banded(jp, jpd, Sj, sigma)
            Ft = factor_banded(tp, pd_host, St, sigma)
            return Fj, Ft
        except np.linalg.LinAlgError:
            sigma *= 16.0
    raise AssertionError("no σ factors S + σI")


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("pre", ["banded", "jacobi"])
def test_cert_eig_device_matches_jax(graphs, pre, dtype):
    jp, tp = graphs["multi_2d"]
    Y = _not_psd_point(jp, tp)
    jpd = jp.device_data(dtype=dtype)
    pd = tp.device_data(dtype, "cpu")
    X0 = np.random.default_rng(0).standard_normal((pd.size, 10)).astype(
        dtype)
    eta, it1, it2, tol = 1e-3, 3, 157, 1e-3
    Yj, Yt = jnp.asarray(Y, dtype), torch.as_tensor(Y.astype(dtype))
    Lj = jax_cert._lam_jit(jpd, Yj)
    Lt = certify.compute_lambda_blocks(pd, Yt)
    bj = bt = None
    if pre == "banded":
        Fj, Ft = _factors(jp, tp, Y)
        bj = jax_device_factor(jpd, Fj, dtype=jpd.dtype())
        bt = device_factor(pd, Ft)
    ref = jax_cert._cert_eig_device(jpd, Yj, *Lj, jnp.asarray(X0), eta,
                                    it1=it1, it2=it2, tol=tol, bfac=bj)
    theta, x, X_blk, iters, resnorm = certify._cert_eig_device(
        pd, *Lt, torch.as_tensor(X0), eta, it1, it2, tol, bfac=bt)
    ref_theta = float(ref[0])
    assert ref_theta < -eta  # not PSD: the escape direction is the point
    assert abs(theta - ref_theta) <= 1e-6 * abs(ref_theta) if \
        dtype == np.float64 else abs(theta - ref_theta) <= 1e-3 * abs(
            ref_theta)
    assert abs(iters - int(ref[3])) <= 2
    assert X_blk.shape == (pd.size, 10) and torch.equal(x, X_blk[:, 0])
    xj = np.asarray(ref[1], np.float64)
    x = x.double().numpy()
    assert abs(x @ xj) / (np.linalg.norm(x) * np.linalg.norm(xj)) >= 1 - 1e-4
    assert np.isfinite(resnorm)


# ---------------------------------------------------------------------------
# the polish


@pytest.fixture(scope="module")
def points(graphs):
    """(kind, name) → the JAX package's float64 TNT iterate from a numpy
    start: "saddle", its solution at rank d (the escape's start); "near",
    its solution at rank d + 1 (the polish's start); "mid", its iterate
    after 20 iterations at rank d + 1, where the Newton-CG runs several
    iterations and stays well conditioned (near the critical point its
    indefinite CG amplifies the rounding)."""
    out = {}
    for name, (jp, _) in graphs.items():
        jpd = jp.device_data(dtype=np.float64)
        jpre = jp.preconditioner_fn(JaxPrecond.REGULARIZED_CHOLESKY,
                                    dtype=np.float64)
        for kind, rank, its in (("saddle", jp.dim, None),
                                ("near", jp.dim + 1, None),
                                ("mid", jp.dim + 1, 20)):
            A = np.random.default_rng(4).uniform(-1.0, 1.0, (jpd.size, rank))
            Y0 = jr.project_to_manifold(jpd, jnp.asarray(A))
            p = JaxTNTParams() if its is None else \
                JaxTNTParams(max_iterations=its)
            out[kind, name] = np.asarray(jax_tnt(jpd, Y0, jpre, p).x)
    return out


def _polish_inputs(jp, tp, Y):
    """(problem data, preconditioner, Y padded to the polish's rank)."""
    pd = tp.device_data(np.float64, "cpu")
    pre = tp.preconditioner_fn(Preconditioner.REGULARIZED_CHOLESKY,
                               np.float64, 1e6, "cpu")
    A = np.zeros((pd.size, polish.POLISH_PAD_RANK))
    A[:, :Y.shape[1]] = Y
    return pd, pre, project_to_manifold(pd, torch.as_tensor(A))


@pytest.mark.parametrize("name", ["multi_2d", "chain_3d"])
def test_newton_step_matches_jax(graphs, points, name):
    """With the CG running several iterations, and with a cap of one."""
    jp, tp = graphs[name]
    pd, pre, Y = _polish_inputs(jp, tp, points["mid", name])
    _, jax_step, _, _ = _jax_polish_kernels(jp, 1e6)
    for tau, max_cg in ((1e-3, 60), (1.0, 1)):
        f, grad, gn, s, gdir, k = polish.newton_step(pd, pre, Y, tau, max_cg)
        rf, rgrad, rgn, rs, rgdir, rk = jax_step(
            jnp.asarray(Y.numpy()), jnp.asarray(tau, jnp.float64),
            jnp.asarray(max_cg, jnp.int64))
        assert abs(f - float(rf)) <= 1e-12 * abs(float(rf))
        assert abs(gn - float(rgn)) <= 1e-12 * float(rgn)
        rs = np.asarray(rs)
        assert np.abs(s.numpy() - rs).max() <= 1e-10 * np.abs(rs).max()
        assert np.abs(grad.numpy() - np.asarray(rgrad)).max() <= \
            1e-12 * np.abs(np.asarray(rgrad)).max()
        assert abs(gdir - float(rgdir)) <= 1e-10 * abs(float(rgdir))
        assert k == int(rk) and (k > 3 if max_cg > 1 else k == 1)


def test_newton_step_blocks_same_bits(graphs, points):
    jp, tp = graphs["multi_2d"]
    pd, pre, Y = _polish_inputs(jp, tp, points["mid", "multi_2d"])
    runs = []
    for block in BLOCKS:
        with device_loop(cg_block=block):
            runs.append(polish.newton_step(pd, pre, Y, 1e-3, 60))
    assert runs[0][5] > 3  # CG runs of several iterations
    for r in runs[1:]:
        assert r[0] == runs[0][0] and r[2] == runs[0][2]
        assert r[4] == runs[0][4] and r[5] == runs[0][5]
        assert _same_bits(r[1], runs[0][1]) and _same_bits(r[3], runs[0][3])


@pytest.mark.parametrize("name", ["multi_2d", "chain_3d"])
def test_polish_solution_matches_jax(graphs, points, name):
    jp, tp = graphs[name]
    Y = points["near", name]
    ref = jax_polish(jp, jp.device_data(dtype=np.float64), Y,
                     time_budget=120.0)
    out = polish.polish_solution(tp, Y, time_budget=120.0, device="cpu")
    assert out.status == ref.status
    assert out.iterations == ref.iterations
    assert abs(out.f - ref.f) <= 1e-10 * abs(ref.f)
    assert out.Y.shape == Y.shape


# ---------------------------------------------------------------------------
# the saddle escape


@pytest.mark.parametrize("name", ["multi_2d", "chain_3d"])
def test_escape_ladder_matches_jax(graphs, points, name):
    """At a rank-d saddle and its certificate's eigenvector (the JAX
    package's): the 48 trials' scalars, the accepted α and the escaped
    state."""
    jp, tp = graphs[name]
    Y = points["saddle", name]
    N = Y.shape[0]
    jpd = jp.device_data(dtype=np.float64)
    cert = jax_cert.certify_solution(jp, jpd, Y, 1e-5, method="auto")
    assert not cert.is_certified and cert.theta < 0
    theta, v = cert.theta, cert.x / np.linalg.norm(cert.x)
    jpre = jp.preconditioner_fn(JaxPrecond.REGULARIZED_CHOLESKY,
                                dtype=np.float64)
    pd = tp.device_data(np.float64, "cpu")
    pre = tp.preconditioner_fn(Preconditioner.REGULARIZED_CHOLESKY,
                               np.float64, device="cpu")
    Y_aug = np.concatenate([Y, np.zeros((N, 1))], axis=1)
    Ydot = np.zeros_like(Y_aug)
    Ydot[:, -1] = v
    alpha0 = max(100 * 1e-4 / abs(theta), 1.0)
    alphas = alpha0 * 0.5 ** np.arange(saddle.N_ALPHAS)
    pfn, pfac = _normalize_precon(jpre)
    signed, *ref = jax_saddle._trial_ladder(
        jpd, jnp.asarray(Y_aug), jnp.asarray(Ydot), jnp.asarray(alphas),
        pfac, pfn, None)
    got = saddle._trial_ladder(
        pd, torch.as_tensor(Y_aug), torch.as_tensor(Ydot),
        torch.as_tensor(np.asarray(signed)), pre,
        lambda V: saddle.data_matrix_product(pd, V)).numpy()
    for row, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(row - r).max() <= 1e-10 * np.abs(r).max()
    out = saddle.saddle_escape(pd, torch.as_tensor(Y), theta, v, pre)
    want = np.asarray(jax_saddle.saddle_escape(jpd, jnp.asarray(Y), theta,
                                               v, jpre))
    assert np.abs(out.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(want[:, -1]).max() > 0  # it left the saddle


# ---------------------------------------------------------------------------
# no host read inside a step function


class _HostRead(AssertionError):
    pass


def _forbid_host_reads(monkeypatch):
    def read(self, *a, **k):
        raise _HostRead("a host read inside a step function")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)


@pytest.mark.parametrize("loop", ["lobpcg", "certificate", "polish"])
def test_step_functions_make_no_host_read(graphs, monkeypatch, loop):
    jp, tp = graphs["multi_2d"]
    if loop == "polish":
        pd, pre, Y = _polish_inputs(jp, tp, _not_psd_point(jp, tp))
        nl = polish._NewtonCG(pd, pre, *Y.shape, Y.device, 3, False)
        nl.Y.copy_(Y)
        nl.tau.fill_(0.5)
        nl.cap.fill_(60)
        steps = [nl._setup, nl._block, nl._block, nl._finish]
        counter = nl.t["k"]
    else:
        Y = _not_psd_point(jp, tp)
        pd = tp.device_data(np.float64, "cpu")
        Lt = certify.compute_lambda_blocks(pd, torch.as_tensor(Y))
        X0 = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (pd.size, 10)))
        cl = certify._CertLoop(pd, pd.size, 10, torch.float64, "cpu", 1e-3,
                               None, (3, 3), False, False)
        cl.load(*Lt, 1e-3, X0, None)
        lp = cl.stage1 if loop == "lobpcg" else cl.stage2
        lp.cap.fill_(30)
        lp.early.fill_(-1e30)  # no early stop: the blocks run
        if loop == "certificate":
            lp.X0.copy_(X0)
        steps = [lp._setup, lp._block, lp._block]
        counter = lp.c["it"]
    with monkeypatch.context() as m:
        _forbid_host_reads(m)
        for step in steps:
            step()
    with monkeypatch.context() as m:
        _forbid_host_reads(m)
        with pytest.raises(_HostRead):
            bool(counter)
    assert 0 < int(counter) <= 6  # two blocks of 3 ran
