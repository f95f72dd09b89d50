"""A cell as its files describe it: the manifest's entry, the configuration
(`configs/<name>.json`), the traffic mix (`traffic/<name>.json`) and the
limits of its comparison (`limits/<cell>.json`), found by name."""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list

    @property
    def path(self) -> str:
        """The TNT path every solve of the cell must take."""
        return self.config["path"]


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str) -> Cell:
    """The cell `name` of the checkout's `BENCHMARK.json`."""
    manifest = read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"], config=read_json(ROOT / conf["file"]),
        traffic=read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(BENCH / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)],
    )


def graph_text(cell: Cell, noise_seed: int) -> str:
    """The cell's graph as PyFG text, its noise drawn from `noise_seed`."""
    g = cell.config["graph"]
    family = importlib.import_module(f"benchmark.graphs.{g['family']}")
    return family.generate(g, noise_seed)


def pool(cell: Cell) -> list:
    """The traffic's fixed set of solves: (graph noise seed, start seed) of
    each, drawn from the traffic file's `pool.seed`. Every run solves this
    same set; `--seed` only orders it."""
    p = cell.traffic["pool"]
    return [tuple(int(x) for x in np.random.SeedSequence(
        [p["seed"], j]).generate_state(2) & 0x7FFFFFFF)
        for j in range(p["size"])]


def order(seed: int, size: int, n_pass: int) -> list:
    """The order of the set's solves in pass `n_pass` of the run of
    `seed` (any whole number; negative ones mapped to 64 bits)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64,
                                                        n_pass]))
    return rng.permutation(size).tolist()


def solver_config(cell: Cell, start_seed: int):
    """The `SolverConfig` of the configuration and the traffic, seeded."""
    from cora_tpu_torch.types import (
        CertParams,
        Formulation,
        Initialization,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )

    s = dict(cell.config["solver"])
    s["preconditioner"] = Preconditioner(s["preconditioner"])
    s["formulation"] = Formulation(s["formulation"])
    s["dtype"] = np.dtype(s["dtype"]).type
    s["tnt"] = TNTParams(**s["tnt"])
    s["cert"] = CertParams(**s["cert"])
    t = cell.traffic
    return SolverConfig(
        **s, init_rank_jump=t["init_rank_jump"],
        initialization=Initialization(t["initialization"]), seed=start_seed)


def start(cell: Cell, n_rows: int, dim: int, start_seed: int):
    """The traffic's start for a solve: None (the program's own start from
    `config.seed`), or uniform in [low, high] of N × (d + jump), both
    from `start_seed`."""
    t = cell.traffic
    if t["start"] == "program":
        return None
    if t["start"] == "uniform":
        return np.random.default_rng(start_seed).uniform(
            t["low"], t["high"], (n_rows, dim + t["init_rank_jump"]))
    raise ValueError(f"start {t['start']!r}")
