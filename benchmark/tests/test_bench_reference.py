"""The reference: what it imports, that it accepts the port's solves of
small graphs of each family, and that it rejects altered outputs and the
control."""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from benchmark.core import cell as cells
from benchmark.core import session
from benchmark.reference import check, control
from benchmark.reference import problem as ref_problem
from benchmark.reference.pyfg import parse
from benchmark.tests.conftest import SMALL, small_cell

FORBIDDEN = {"cora_tpu_torch", "cora_tpu", "jax", "jaxlib", "flax"}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.check, benchmark.reference.control, "
            "benchmark.reference.ate, benchmark.work.tnt; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(cells.ROOT)],
                         capture_output=True, text=True, check=True)
    assert not FORBIDDEN & set(json.loads(out.stdout))


@pytest.fixture(scope="module", params=sorted(SMALL))
def solved(request):
    """One plain-path solve (device="cpu") of a small graph of the cell's
    family, through the benchmark's own solve path."""
    cell = small_cell(request.param)
    text = cells.graph_text(cell, 2 ** 31 + 5)
    rec = session.Recorder()
    with rec.installed(), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.pyfg")
        with open(path, "w") as f:
            f.write(text)
        s = session.solve_once(cell, path, 9, 2, "cpu", rec, False)
    assert not s.error and not s.path_error
    s.Y_cert = s.certified_point()
    g = parse(text)
    return cell, g, ref_problem.data_matrix(g), session.outputs(s)


def judged(cell, g, Q, out):
    nums = check.judge(g, Q, cell.config["solver"]["cert"], out)
    return check.verdict(nums, cell.limits)[0], nums


def test_accepts_the_ports_solve(solved):
    ok, nums = judged(*solved)
    assert ok, nums


def test_rejects_a_perturbed_certified_point(solved):
    cell, g, Q, out = solved
    Y = out["Y_cert"] + 1e-3 * np.random.default_rng(0).standard_normal(
        out["Y_cert"].shape)
    ok, nums = judged(cell, g, Q, dict(out, Y_cert=Y))
    assert not ok, nums


def test_rejects_an_estimate_cost_off(solved):
    cell, g, Q, out = solved
    ok, nums = judged(cell, g, Q, dict(out, final_f=out["final_f"] * 1.01))
    assert not ok and nums["final_cost_rel_err"] > cell.limits[
        "final_cost_rel_err"], nums


def test_rejects_an_estimate_off_the_constraints(solved):
    cell, g, Q, out = solved
    est = out["estimate"].copy()
    est[:g.n * g.d] *= 1.001  # every rotation block scaled
    ok, nums = judged(cell, g, Q, dict(out, estimate=est))
    assert not ok and nums["est_feas_err"] > cell.limits["est_feas_err"], nums


def test_bfloat16_rounds_as_torch_does():
    import torch

    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    x *= np.float32(10.0) ** np.random.default_rng(4).integers(-6, 6, 4096)
    want = torch.from_numpy(x).bfloat16().float().numpy()
    assert np.array_equal(control.bfloat16(x), want)


def test_the_float32_control_fails(solved):
    """The control (reference/control.py: float32 for the float64 steps,
    bfloat16 for the estimate) fails at least one number."""
    cell, g, Q, out = solved
    ok, nums = judged(cell, g, Q, control.control_outputs(g, out))
    assert not ok, nums


def test_cost_is_half_the_quadratic_form(solved):
    _, g, Q, _ = solved
    Y = np.random.default_rng(1).standard_normal((g.size, 4))
    assert ref_problem.cost(g, Y) == pytest.approx(0.5 * np.sum(Y * (Q @ Y)),
                                                   rel=1e-12)


def test_a_whole_run_on_the_cpu_is_correct():
    """session.run past the card check: set-up, a window of one solve, the
    comparison; the result line's keys with `checks` last."""
    name = "plaza2_shaped.random_jump2"
    cell = small_cell(name, pool=2)
    result = session.run(cell, 3, 0.01, False, "cpu", time.time())
    assert result["correct"] and result["attempted"] == 2
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"solve_s", "t_cert_s", "setup_s"}
