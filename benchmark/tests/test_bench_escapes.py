"""The reader of the program's escape count (`escapes`): the mean of the
timed solves' `escape.escapes`, and nothing from a program whose
`CoraResult.counters` lacks it."""

import pytest

from benchmark.core import session
from benchmark.tests.test_bench_program_spans import fake_run


@pytest.mark.parametrize("counts, mean", [
    ([3, 0], 1.5),
    ([0, 0], 0.0),
    ([1, 2, 6], 3.0),
])
def test_escapes_reads_the_mean_count(counts, mean):
    solves = [dict(phases={"tnt_level": 1.0},
                   counters={"escape.escapes": n, "tnt.captures": 3})
              for n in counts]
    assert session.read_metric("escapes", fake_run(solves)) == \
        pytest.approx(mean)


@pytest.mark.parametrize("counters", [None, {}, {"tnt.captures": 3}],
                         ids=["no-counters", "empty", "loops-only"])
def test_escapes_reads_nothing_without_the_count(counters):
    solves = [dict(phases={"tnt_level": 1.0}, counters=counters)] * 2
    assert session.read_metric("escapes", fake_run(solves)) is None
