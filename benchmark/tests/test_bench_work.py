"""The roofline's work count against a hand count on two tiny graphs."""

import numpy as np
import pytest

from benchmark.reference import problem
from benchmark.reference.pyfg import Graph
from benchmark.work import tnt

I2 = np.eye(2)


def graph(poses, landmarks, edges, ranges):
    """Identity rotations, unit translations and weights."""
    n, E = len(poses), len(edges)
    return Graph(
        d=2, poses=poses, landmarks=landmarks, gt_R=np.stack([I2] * n),
        gt_t=np.zeros((n, 2)), gt_lm=np.zeros((len(landmarks), 2)),
        e_i=np.array([e[0] for e in edges]), e_j=np.array([e[1] for e in edges]),
        e_R=np.stack([I2] * E), e_t=np.ones((E, 2)), kappa=np.ones(E),
        tau=np.ones(E), r_a=np.array([r[0] for r in ranges]),
        r_b=np.array([r[1] for r in ranges]), r_dist=np.ones(len(ranges)),
        r_prec=np.ones(len(ranges)))


# a0 → a1 → a2, a range from a1 to the landmark L0 (translation row 3):
# N = 3·3 + 1 + 1 = 11. Without L0, t_a1 touches 7 rows (both blocks it
# is measured from, a0's and a2's translations, the bearing), so no order
# has a band under 4; RCM finds 4: 10·5 − 4·5/2 = 40 entries, L0's spike
# 10 + 1.
CHAIN = graph(["a0", "a1", "a2"], ["L0"], [(0, 1), (1, 2)], [(1, 3)])
# A0 → A1, B0 → B1, a range A1–B0: N = 4·3 + 1 = 13; t_A1 touches 5 rows,
# so the band is at least 3, which RCM finds: 13·4 − 3·4/2 = 46 entries.
TWO_ROBOTS = graph(["A0", "A1", "B0", "B1"], [], [(0, 1), (2, 3)], [(1, 2)])


@pytest.mark.parametrize("g, band, hand", [
    (CHAIN, (4, 40, 11), {
        # edges 2·((4 + 2 + 2)·4 + 2·4) + range (2·4 + 2·4) = 96; Λ (3·4 +
        # 1)·4 = 52; factor (40 + 11)·4 = 204; Y, V, two outputs 4·11·4·4
        "tcg_bytes": 96 + 52 + 204 + 704,
        # Q·V 2·(4·4·4 + 7·2·4 + 6·4) + 10·4 = 328; Λ·V 3·2·4·4 + 2·4 =
        # 104; two projections 2·(3·4·4·4 + 4·4) = 416; solves 4·51·4
        "tcg_flops": 328 + 104 + 416 + 816,
        "outer_bytes": 96 + 204 + 704,
        # one projection 208; retraction 3·4·4·4 + 3·4 = 204
        "outer_flops": 328 + 104 + 208 + 816 + 204}),
    (TWO_ROBOTS, (3, 46, 0), {
        "tcg_bytes": 96 + 68 + 184 + 832,
        "tcg_flops": 328 + 136 + 544 + 736,
        "outer_bytes": 96 + 184 + 832,
        "outer_flops": 328 + 136 + 272 + 736 + 268}),
])
def test_hand_count(g, band, hand):
    assert tnt.band_entries(g, problem.data_matrix(g)) == band
    assert tnt.level_work(g, band[1], band[2], 4) == hand


def test_least_seconds_takes_the_larger_bound():
    work = {"tcg_bytes": 3.35e6, "tcg_flops": 1.0,
            "outer_bytes": 1.0, "outer_flops": 6.7e7}
    peaks = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}
    assert tnt.least_seconds(work, peaks, 10, 2) == pytest.approx(10e-6 + 2e-6)
