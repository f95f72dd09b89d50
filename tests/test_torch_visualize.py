"""`python -m cora_tpu_torch.visualize`, the port's counterpart of the JAX
package's `examples/visualize.py`, on the CPU (`--device cpu`).

  * the still: the solve and `plot_solution`, the same title as the JAX
    CLI's, its cost that of the JAX package's solve of the same file;
  * `--animate`: a GIF of the logged TNT iterates;
  * `--calibration`: the range-calibration plots, with no solve;
  * the solve half (`visualize.solve`), still and `--animate`: float64
    on the canonical path, as the JAX CLI's, its certificate and cost
    those of the JAX package's solve of the same file, the iterates
    logged only with `--animate`;
  * a missing dataset exits non-zero;
  * the solve half (`visualize.solve`) does not import matplotlib.
The drawing tests need matplotlib (`pytest.importorskip`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cora_tpu_torch import visualize
from cora_tpu_torch.solve import staircase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

# one robot's odometry chain with landmark ranges (the kernels' graphs)
CHAIN = dict(n_robots=1, poses_per_robot=14, n_inter_ranges=0,
             n_landmarks=2, n_landmark_ranges=10, n_loop_closures=0, dim=2,
             seed=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("viz") / "chain.pyfg"
    path.write_text(multi_robot_pyfg(**CHAIN))
    return str(path)


def test_still_matches_the_jax_cli(dataset, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    jax = pytest.importorskip("jax")  # noqa: F841
    from cora_tpu import parse_pyfg as jax_parse
    from cora_tpu import solve_cora as jax_solve
    from cora_tpu.types import SolverConfig as JaxConfig

    titles = []
    from cora_tpu_torch.io import viz

    plot = viz.plot_solution

    def recording(*args, **kwargs):
        titles.append(kwargs.get("title"))
        return plot(*args, **kwargs)

    monkeypatch.setattr(viz, "plot_solution", recording)
    out = tmp_path / "still.png"
    assert visualize.main([dataset, str(out), "--device", "cpu"]) == 0
    assert out.stat().st_size > 0
    ref = jax_solve(jax_parse(dataset), config=JaxConfig(seed=0))
    assert titles == [f"chain.pyfg (cost {ref.result.f:.3f}, certified "
                      f"{ref.certified})"]


def test_animate_writes_a_gif(dataset, tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "anim.gif"
    assert visualize.main([dataset, str(out), "--animate", "--max-frames",
                           "5", "--fps", "4", "--device", "cpu"]) == 0
    assert out.read_bytes()[:3] == b"GIF"


def test_calibration_needs_no_solve(dataset, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")

    def no_solve(*args, **kwargs):
        raise AssertionError("--calibration solved")

    monkeypatch.setattr(staircase, "solve_cora", no_solve)
    out = tmp_path / "calib.png"
    assert visualize.main([dataset, str(out), "--calibration",
                           "--device", "cpu"]) == 0
    assert out.stat().st_size > 0


@pytest.mark.parametrize("animate", [False, True], ids=["still", "animate"])
def test_solve_half_matches_the_jax_package(dataset, monkeypatch, animate):
    jax = pytest.importorskip("jax")  # noqa: F841
    from cora_tpu import parse_pyfg as jax_parse
    from cora_tpu import solve_cora as jax_solve
    from cora_tpu.types import SolverConfig as JaxConfig

    called = []
    for name in ("tnt_solve", "tnt_solve_tiles"):
        run = getattr(staircase, name)
        monkeypatch.setattr(staircase, name, lambda *a, _r=run, _n=name,
                            **k: called.append(_n) or _r(*a, **k))
    problem, cfg, res = visualize.solve(dataset, animate, "cpu",
                                        verbose=False)
    # the CLI's config: float64, so the canonical path, as the JAX CLI's
    assert cfg.dtype == np.float64 and cfg.log_iterates == animate
    assert called and set(called) == {"tnt_solve"}
    assert (len(res.result.iterates) > 0) if animate \
        else not res.result.iterates
    ref = jax_solve(jax_parse(dataset),
                    config=JaxConfig(seed=0, log_iterates=animate))
    assert res.certified == ref.certified
    np.testing.assert_allclose(res.result.f, ref.result.f, rtol=1e-4)


def test_missing_dataset_exits_nonzero(tmp_path):
    missing = str(tmp_path / "none.pyfg")
    assert visualize.main([missing, str(tmp_path / "x.png"),
                           "--device", "cpu"]) != 0
    proc = subprocess.run([sys.executable, "-m", "cora_tpu_torch.visualize",
                           missing, str(tmp_path / "x.png"), "--device",
                           "cpu"], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode != 0 and "none.pyfg" in proc.stderr
    assert not (tmp_path / "x.png").exists()


def test_solve_half_imports_no_matplotlib():
    code = ("import sys; import cora_tpu_torch.visualize as v; "
            "import cora_tpu_torch.solve.staircase; "
            "sys.exit('matplotlib' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO).returncode \
        == 0
