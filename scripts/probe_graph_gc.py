"""Does destroying a CUDA graph while another is being captured invalidate
that capture? And does Python's cycle collector do so when it frees a
dropped loop's graph inside a capture?

Each case runs in a process of its own (an invalidated capture may leave
the process's allocator mid-capture) and prints one line: the case, ok or
the error. Cases:

- `del`: graph g1 captured and replayed; g2's capture drops g1's last
  reference;
- `collect`: g1 held only by a reference cycle (as a loop dropped from
  `utils.graphs.keep` is); `gc.collect()` inside g2's capture;
- `collect_no_graph`: the same with no graph in the cycle (tensors only);
- `threshold`: the `collect` case with the collector run by its own
  threshold (`gc.set_threshold(1)`, then Python objects allocated; the
  threshold is 10**6 everywhere else, so nothing is collected before);
- `held`: `threshold` inside `utils.graphs.collector_held`, the capture's
  guard: nothing is collected inside the capture.

Run on a CUDA machine: python3 scripts/probe_graph_gc.py
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

CASES = ("del", "collect", "collect_no_graph", "threshold", "held")


def run_case(case: str):
    import gc

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cora_tpu_torch.utils.graphs import collector_held

    x = torch.zeros(1 << 16, device="cuda")
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())

    def capture(fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s):
            x.add_(1)  # warm-up
            g.capture_begin()
            try:
                fn()
            finally:
                g.capture_end()
        torch.cuda.current_stream().wait_stream(s)
        return g

    class Cycle:
        def __init__(self, g):
            self.g, self.me = g, self

    g1 = capture(lambda: x.mul_(2))
    g1.replay()
    torch.cuda.synchronize()
    gc.collect()
    # no collection but the case's own: the cycle below stays garbage
    # until the case runs
    gc.set_threshold(10 ** 6)
    if case == "del":
        holder = [g1]
        del g1

        def body():
            x.add_(1)
            holder.clear()
    else:
        Cycle(torch.ones(8, device="cuda") if case == "collect_no_graph"
              else g1)
        del g1

        def body():
            x.add_(1)
            if case in ("threshold", "held"):
                guard = collector_held() if case == "held" \
                    else contextlib.nullcontext()
                with guard:
                    gc.set_threshold(1)
                    junk = [dict(i=i) for i in range(1000)]
                    gc.set_threshold(10 ** 6)
                    x.add_(len(junk))
            else:
                gc.collect()
    g2 = capture(body)
    g2.replay()
    torch.cuda.synchronize()
    gc.set_threshold(700)
    gc.collect()  # outside any capture: the cycle goes here
    print(json.dumps({"case": case, "ok": True}), flush=True)


def main():
    if len(sys.argv) > 1:
        run_case(sys.argv[1])
        return
    for case in CASES:
        p = subprocess.run([sys.executable, __file__, case],
                           capture_output=True, text=True, timeout=120)
        if p.returncode == 0:
            print(p.stdout.strip(), flush=True)
        else:
            err = [ln for ln in p.stderr.splitlines() if "Error" in ln]
            print(json.dumps({"case": case, "ok": False,
                              "error": err[-3:]}), flush=True)


if __name__ == "__main__":
    main()
