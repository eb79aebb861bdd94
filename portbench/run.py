#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port beside ``BENCHMARK.json``,
on a machine with as many CUDA cards as the cell asks for (it uses the
first). The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` a ``breakdown``,
and last ``checks``: each number the correctness check compared, beside
its limit. The same numbers are the last lines on standard error.

Exits non-zero, printing no result, without enough cards, without the
port, or when a module of the JAX stack or package is loaded once the
window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(REPO, "build", "portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
    import torch

    from harness import find, forbidden_modules, load_spec, run_cell

    spec = load_spec(REPO)
    chips = find(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(1, REPO)  # the port, beside the benchmark in the checkout
    torch.set_num_threads(1)
    result, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec,
                         t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX stack or package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
