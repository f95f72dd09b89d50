"""Each configuration's generated graph has the totals its file states."""

import json
import pathlib

import pytest

from benchmark.core import cell as cells
from benchmark.reference.pyfg import parse

MANIFEST = json.loads((cells.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_totals(workload):
    cell = cells.load(workload)
    text = cells.graph_text(cell, 2 ** 31 + 7)
    assert parse(text).totals() == cell.config["totals"]


@pytest.mark.parametrize("family", ["plaza_chain", "multi_robot"])
def test_noise_alone_moves_with_the_seed(family):
    """Two seeds give the same records with other measured values."""
    cell = next(cells.load(w["name"]) for w in MANIFEST["workloads"]
                if cells.load(w["name"]).config["graph"]["family"] == family)
    a, b = (parse(cells.graph_text(cell, s)) for s in (1, 2))
    assert (a.e_i == b.e_i).all() and (a.r_a == b.r_a).all()
    assert (a.gt_t == b.gt_t).all()
    assert (a.r_dist != b.r_dist).any() and (a.e_t != b.e_t).any()


def test_files_are_named_by_the_manifest():
    for w in MANIFEST["workloads"]:
        for part in ("traffic", "limits"):
            name = w["traffic"] if part == "traffic" else w["name"]
            assert (cells.BENCH / part / f"{name}.json").exists()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (cells.BENCH / "metrics" / f"{m['name']}.py").exists()
    for c in MANIFEST["configs"]:
        assert pathlib.Path(cells.ROOT / c["file"]).exists()
