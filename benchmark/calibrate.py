"""The readings that a cell's limits are set from, on the card.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed: the cell's graph with its noise and its start from that
seed (inputs beyond the traffic's fixed set), one solve through the
benchmark's own solve path (`core/session.solve_once`, as a window's solve),
the reference's numbers for the program's outputs (the lower readings) and,
on the first three seeds, for the control's (`reference/control.py`, one
precision below the configuration's in the program's place: the upper
readings) and for a second solve with each fault of `--faults` planted
(`benchmark/faults.py`). Prints a JSON line per seed, then per number the
largest sound reading and the smallest control and fault readings. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROL_SEEDS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from benchmark import faults
    from benchmark.core import cell as cells
    from benchmark.core import session
    from benchmark.reference import check, control
    from benchmark.reference import problem as ref_problem
    from benchmark.reference.pyfg import parse as ref_parse

    cell = cells.load(args.workload)
    cert_params = cell.config["solver"]["cert"]
    rec = session.Recorder()
    rows = []
    with rec.installed(), tempfile.TemporaryDirectory() as tmp:
        for i, seed in enumerate(args.seeds):
            text = cells.graph_text(cell, seed)
            path = os.path.join(tmp, "g.pyfg")
            with open(path, "w") as f:
                f.write(text)
            s = session.solve_once(cell, path, seed, str(seed), "cuda", rec,
                                   False)
            if s.error:
                rows.append({"seed": seed, "error": s.error})
                continue
            s.Y_cert = s.certified_point()
            g = ref_parse(text)
            Q_ref = ref_problem.data_matrix(g)
            t0 = time.perf_counter()
            out = session.outputs(s)
            row = {"seed": seed, "wall_s": s.wall_s,
                   "ranks": s.result.ranks_visited,
                   "path_error": s.path_error,
                   "sound": check.judge(g, Q_ref, cert_params, out)}
            row["reference_s"] = time.perf_counter() - t0
            if i < CONTROL_SEEDS:
                row["control"] = check.judge(
                    g, Q_ref, cert_params, control.control_outputs(g, out))
                for name in args.faults:
                    with faults.planted(name):
                        f = session.solve_once(cell, path, seed, str(seed),
                                               "cuda", rec, False)
                    f.Y_cert = f.certified_point()
                    row[name] = check.judge(g, Q_ref, cert_params,
                                            session.outputs(f))
            rows.append(row)
            print(json.dumps(row), flush=True)

    summary = {}
    for name in check.NUMBERS + check.READINGS:
        summary[name] = {}
        for kind, pick in [("sound", max), ("control", min)] + [
                (f, min) for f in args.faults]:
            vals = [r[kind][name] for r in rows if name in r.get(kind, {})]
            summary[name][kind] = pick(vals) if vals else None
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
