"""The plain versions of the four CUDA kernels (`PlainTNT`) against the JAX
package's Pallas kernels (`PallasTNT`, interpreter mode), from the same
numpy-made inputs, in float32 on the CPU.

Tolerances (derived on these graphs; the two sides sum in different
orders, so agreement is to float32 rounding amplified by the problem's
conditioning, κ ~ 1e4 rotation precisions):
  * states (retracted Y, chunk Y): 2e-5 relative to the state's max;
  * f: 1e-4 relative; gradient norms 1e-4; √⟨g,Pg⟩ 1e-3;
  * tCG: iterations within 2, `hit` equal, model decrease 2e-2,
    ‖s‖ 2e-2.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu.models.synthetic import synthetic_problem as jax_problem  # noqa: E402
from cora_tpu.ops import tiles as T  # noqa: E402
from cora_tpu.ops.pallas_tcg import PallasTNT  # noqa: E402
from cora_tpu.ops.riemannian import project_to_manifold  # noqa: E402
from cora_tpu.solve.tnt import HashableParams as JaxParams  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import chain  # noqa: E402
from cora_tpu_torch.ops.tnt_kernels import PlainTNT  # noqa: E402
from cora_tpu_torch.solve.tnt import HashableParams  # noqa: E402
from cora_tpu_torch.types import TNTParams  # noqa: E402

CASES = [(2, 3), (3, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _setup(dim, rank, seed=1):
    key = (dim, rank)
    if key in _CACHE:
        return _CACHE[key]
    g = dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=dim, seed=seed)
    jp = jax_problem(**g)
    jpd = jp.device_data(dtype=np.float32)
    plan_t = T.build_tile_plan(jp, jpd, rank, dtype=np.float32)
    jk = PallasTNT(plan_t, JaxParams(JaxTNTParams()), interpret=True)
    tp = synthetic_problem(**g)
    plan = chain.build_chain_plan(tp, dtype=np.float32)
    pk = PlainTNT(plan, HashableParams(TNTParams()))
    rng = np.random.default_rng(seed)
    Y = np.array(project_to_manifold(
        jpd, jnp.asarray(rng.uniform(-1, 1, (jpd.size, rank)), jnp.float32)))
    V = (0.1 * rng.standard_normal(Y.shape)).astype(np.float32)
    _CACHE[key] = (plan_t, jk, pk, Y, V)
    return _CACHE[key]


def _canon(plan_t, tiles):
    return np.asarray(T.from_tiles(plan_t, *tiles))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("dim,rank", CASES)
@pytest.mark.parametrize("flag", [1, 0])
def test_step_plain_vs_pallas(dim, rank, flag):
    plan_t, jk, pk, Y, V = _setup(dim, rank)
    Yn, QY, grad, f, gn, pgn = jk.step(
        T.to_tiles(plan_t, jnp.asarray(Y)), T.to_tiles(plan_t, jnp.asarray(V)),
        jnp.asarray(flag, jnp.int32))
    tYn, tQY, tgrad, scal = pk.step(torch.as_tensor(Y), torch.as_tensor(V),
                                    bool(flag))
    assert _rel(tYn, _canon(plan_t, Yn)) < 2e-5
    assert _rel(tQY, _canon(plan_t, QY)) < 1e-4
    assert _rel(tgrad, _canon(plan_t, grad)) < 1e-4
    np.testing.assert_allclose(float(scal[0]), float(f), rtol=1e-4)
    np.testing.assert_allclose(float(scal[1]), float(gn), rtol=1e-4)
    np.testing.assert_allclose(float(scal[2]), float(pgn), rtol=1e-3)


@pytest.mark.parametrize("dim,rank", CASES)
def test_tcg_plain_vs_pallas(dim, rank):
    plan_t, jk, pk, Y, V = _setup(dim, rank)
    # the tCG input: f, grad and ∇F at Y, from the plain step
    _, QY, grad, _ = pk.step(torch.as_tensor(Y), torch.as_tensor(V), False)
    s, mdec, hit, k, snorm = jk.tcg(
        T.to_tiles(plan_t, jnp.asarray(grad.numpy())),
        T.to_tiles(plan_t, jnp.asarray(Y)),
        T.to_tiles(plan_t, jnp.asarray(QY.numpy())),
        jnp.asarray(5.0, jnp.float32), jnp.asarray(80, jnp.int32))
    ts, scal = pk.tcg(grad, torch.as_tensor(Y), QY, 5.0, 80)
    t_mdec, t_hit, t_k, t_snorm = scal.tolist()
    assert abs(int(t_k) - int(k)) <= 2
    assert bool(t_hit) == bool(hit)
    np.testing.assert_allclose(t_mdec, float(mdec), rtol=2e-2)
    np.testing.assert_allclose(t_snorm, float(snorm), rtol=2e-2)


def _chunk_inputs(tcg_cap=80, stop_at=8):
    fscal = np.array([0, 0, 0, 5.0, np.inf, 1e-4, 0, 0], np.float32)
    iscal = np.array([0, 0, 0, 0, 0, stop_at, tcg_cap, 60, 24, 10, 1, 0],
                     np.int32)
    return fscal, iscal


@pytest.mark.parametrize("dim,rank", CASES)
def test_chunk_plain_vs_pallas(dim, rank):
    plan_t, jk, pk, Y, V = _setup(dim, rank)
    H = 70
    fscal, iscal = _chunk_inputs()
    Yt = T.to_tiles(plan_t, jnp.asarray(Y))
    zeros = tuple(jnp.zeros_like(t) for t in Yt)
    hists = tuple(jnp.zeros((H,), jnp.float32) for _ in range(4)) + (
        jnp.zeros((H,), jnp.int32),)
    jY, _, _, jfs, jis, jh = jk.chunk(Yt, zeros, zeros, jnp.asarray(fscal),
                                      jnp.asarray(iscal), hists, history_len=H)
    tY = torch.as_tensor(Y).clone()
    tG, tN = torch.zeros_like(tY), torch.zeros_like(tY)
    tfs, tis = torch.as_tensor(fscal).clone(), torch.as_tensor(iscal).clone()
    th = torch.zeros((5, H), dtype=torch.float32)
    pk.chunk(tY, tG, tN, tfs, tis, th)
    jis = np.asarray(jis)
    assert tis[:5].tolist() == jis[:5].tolist()  # k, status, streaks
    k = int(jis[0])
    assert k == 8
    assert _rel(tY, _canon(plan_t, jY)) < 2e-5
    np.testing.assert_allclose(tfs[:3].numpy(), np.asarray(jfs)[:3], rtol=1e-4)
    np.testing.assert_allclose(float(tfs[3]), float(jfs[3]), rtol=1e-6)
    np.testing.assert_allclose(th[0, :k].numpy(), np.asarray(jh[0])[:k],
                               rtol=1e-4)
    assert np.abs(th[4, :k].numpy() - np.asarray(jh[4])[:k]).max() <= 2


@pytest.mark.parametrize("dim,rank", CASES)
def test_ladder_plain_vs_pallas(dim, rank):
    plan_t, jk, pk, Y, V = _setup(dim, rank)
    a0 = 4.0
    alphas = a0 * 0.5 ** np.arange(24)
    signed = np.stack([alphas, -alphas], 1).reshape(-1).astype(np.float32)
    jf, jg, jpg = jk.ladder(T.to_tiles(plan_t, jnp.asarray(Y)),
                            T.to_tiles(plan_t, jnp.asarray(V)),
                            jnp.asarray(signed))
    out = pk.ladder(torch.as_tensor(Y), torch.as_tensor(V),
                    torch.as_tensor(signed)).numpy()
    assert out.shape == (3, 48)
    np.testing.assert_allclose(out[0], np.asarray(jf), rtol=1e-4)
    np.testing.assert_allclose(out[1], np.asarray(jg), rtol=1e-4)
    np.testing.assert_allclose(out[2], np.asarray(jpg), rtol=1e-3)
