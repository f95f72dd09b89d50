"""The benchmark of `cora_tpu_torch` on NVIDIA GPUs: one cell, one run.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Sets up (builds the kernels into the
checkout's `.torch_ext_build/`, writes the cell's graph into `TMPDIR`,
warms a solve), runs solves back to back for `--seconds`, compares every
solve's outputs with the plain reference in `benchmark/reference/`, and
prints one JSON line: the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics, `correct`, and the compared numbers beside their
limits. Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; if the process has loaded JAX or the JAX package,
it exits 3.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cora_tpu")


def loaded_forbidden(modules=None) -> list:
    """Modules loaded (`sys.modules`) whose top-level name is JAX's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from benchmark.core import cell as cells
    from benchmark.core import session

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = session.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        print(f"[bench] the process loaded {bad}: the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    session.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
