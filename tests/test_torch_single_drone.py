"""The single-drone deployment at d = 3, held to the benchmark's plain
reference (`benchmark/reference/`: numpy and scipy, nothing of the port).

Small flights of the configuration's own family
(`benchmark/configs/single_drone_shaped.json`, `benchmark/graphs/
drone_flight.py`: one drone's 3-D odometry chain inside an arena, one
beacon ranged from every pose) are solved through the benchmark's solve
path on the CPU, where the chain kernels run as their plain twins, and
judged against the cell's limits
(`benchmark/limits/single_drone_shaped.random_jump2.json`); they land in
the regime recorded for the real flight (ATE under a metre, the relaxation
tight). A pose whose
rotation is reflected in the estimate keeps every constraint; the judge
has to fail it by its cost, and its stationarity has to rise.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from benchmark.core import cell as cells  # noqa: E402
from benchmark.core import session  # noqa: E402
from benchmark.graphs import drone_flight  # noqa: E402
from benchmark.reference import check, control  # noqa: E402
from benchmark.reference import problem as ref_problem  # noqa: E402
from benchmark.reference.pyfg import parse  # noqa: E402

CELL = "single_drone_shaped.random_jump2"
# the configuration's flight cut to 60 poses, each ranged to the one beacon
SMALL = dict(n_poses=60, n_ranges=60)
# the recorded regime of the real flight (ROADMAP.md: ATE 0.5841 m),
# and how far the certified rank-r cost may lie from the estimate's
ATE_M, GAP = 1.0, 0.01
# graph noise seeds (the start's seed is the noise seed + 7)
NOISE = [2 ** 31 + 5, 11]


@pytest.fixture(scope="module")
def cell():
    c = cells.load(CELL)
    c.config = dict(c.config, graph=dict(c.config["graph"], **SMALL))
    return c


@pytest.fixture(scope="module", params=NOISE)
def solved(request, cell):
    """One solve of a small graph through `session.solve_once` on the CPU,
    and the reference's graph and Q."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        text = cells.graph_text(cell, request.param)
        rec = session.Recorder()
        with rec.installed(), tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "g.pyfg")
            with open(path, "w") as f:
                f.write(text)
            s = session.solve_once(cell, path, request.param + 7, "0", "cpu",
                                   rec, False)
    finally:
        torch.set_num_threads(threads)
    assert not s.error, s.error
    s.Y_cert = s.certified_point()
    g = parse(text)
    return s, g, ref_problem.data_matrix(g), session.outputs(s)


def judged(cell, g, Q, out):
    nums = check.judge(g, Q, cell.config["solver"]["cert"], out)
    return check.verdict(nums, cell.limits)[0], nums


def test_the_configuration_is_at_the_datasets_totals():
    conf = cells.load(CELL).config
    gr, tot = conf["graph"], conf["totals"]
    graph = (gr["dim"], gr["n_poses"], gr["n_landmarks"], gr["n_ranges"])
    assert graph == (3, tot["poses"], tot["landmarks"], tot["ranges"])
    assert graph == (3, 1754, 1, 1754)
    # N = n(d + 1) + m + l: rotation rows, translations, bearings, the beacon
    assert tot["N"] == 1754 * 4 + 1754 + 1 == 8771
    assert conf["path"] == "chain" and conf["reduced"] == []


def test_the_flight_stays_in_the_arena():
    """The configuration's full flight: proper rotations, every pose and
    the beacon inside the arena, steps of a drone's speed."""
    g = cells.load(CELL).config["graph"]
    R, t = drone_flight.flight(g, np.random.default_rng(g["geometry_seed"]))
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-12)
    assert np.allclose(np.linalg.det(R), 1.0, atol=1e-12)
    arena = np.asarray(g["arena_m"])
    assert (t >= drone_flight.MARGIN - 1e-9).all()
    assert (t <= arena - drone_flight.MARGIN + 1e-9).all()
    speed = np.linalg.norm(np.diff(t, axis=0), axis=1) / g["dt"]
    assert 0.2 < np.median(speed) and speed.max() < 2.0
    beacon = parse(cells.graph_text(cells.load(CELL), 1)).gt_lm[0]
    assert (0 <= beacon).all() and (beacon <= arena).all()


def test_noise_alone_moves_with_the_seed(cell):
    a, b = (parse(cells.graph_text(cell, s)) for s in (1, 2))
    assert (a.e_i == b.e_i).all() and (a.r_a == b.r_a).all()
    assert (a.gt_t == b.gt_t).all()
    assert (a.r_dist != b.r_dist).any() and (a.e_t != b.e_t).any()


def test_the_small_graph_is_the_family_at_d3(solved):
    _, g, _, _ = solved
    assert (g.d, g.n, g.l, g.m) == (3, 60, 1, 60)
    assert len(set(g.r_a.tolist())) == g.m and set(g.r_b.tolist()) == {g.n}


def test_the_solve_takes_the_chain_path_at_d3(solved):
    s, g, _, _ = solved
    assert not s.path_error
    # from rank d + 2; a nearly tight relaxation may trim its dead columns
    assert s.result.ranks_visited[0] == g.d + 2
    assert s.Y_cert.shape[0] == g.size and s.Y_cert.shape[1] >= g.d
    assert s.estimate.shape == (g.size, 3)


def test_q_matches_the_reference(cell, solved):
    _, g, Q, out = solved
    assert judged(cell, g, Q, out)[1]["q_rel_err"] <= 1e-12


def test_the_reference_accepts_the_solve(cell, solved):
    s, g, Q, out = solved
    ok, nums = judged(cell, g, Q, out)
    assert ok and out["certified"], nums
    for name, limit in cell.limits.items():
        assert nums[name] <= limit, (name, nums[name], limit)


def test_the_solve_lands_in_the_recorded_regime(cell, solved):
    """Under a metre of trajectory error, and a relaxation so nearly tight
    that the certified rank-r cost lies within a percent of the rank-3
    estimate's."""
    _, g, Q, out = solved
    nums = judged(cell, g, Q, out)[1]
    assert nums["ate_m"] < ATE_M and abs(nums["sdp_minus_final_rel"]) < GAP


def test_a_reflected_rotation_fails_by_cost_and_stationarity(cell, solved):
    """One interior pose's rotation block in the rank-3 estimate reflected
    (a row negated, det −1), its cost left as the program reported it:
    every constraint still holds, the cost reads far off its limit and the
    stationarity ten times the sound estimate's and more. Only the
    odometry's translations pull on the reflected block (in the rotation
    terms alone a reflection between two neighbours is nearly
    stationary), and a drone's steps are short, so the stationarity stays
    below its limit: with the cost reported as computed the judge cannot
    see this fault."""
    _, g, Q, out = solved
    sound = judged(cell, g, Q, out)[1]
    est = np.array(out["estimate"], np.float64)
    i = g.n // 2
    assert np.linalg.det(est[i * g.d:(i + 1) * g.d]) > 0
    est[i * g.d + g.d - 1] *= -1.0
    assert np.linalg.det(est[i * g.d:(i + 1) * g.d]) < 0
    ok, nums = judged(cell, g, Q, dict(out, estimate=est))
    assert not ok, nums
    assert nums["est_feas_err"] <= cell.limits["est_feas_err"]
    assert nums["final_cost_rel_err"] > 100 * cell.limits["final_cost_rel_err"]
    assert nums["est_grad_rel"] > 10 * sound["est_grad_rel"]


def test_the_control_fails(cell, solved):
    """The reference one precision below the configuration's, in the
    port's place (`reference/control.py`), fails the cell's limits."""
    _, g, Q, out = solved
    ok, nums = judged(cell, g, Q, control.control_outputs(g, out))
    assert not ok, nums
