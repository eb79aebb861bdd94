#!/usr/bin/env python3
"""The correctness check's control, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seed <n> [--dtypes float64,float32]

Puts the plain reference in the program's place with its decimal
arithmetic (products and sums) in a floating-point type, and holds every
batch's answer and the final merge of all batches against the exact
reference, as a run holds the program's answers. Prints one JSON line per
type: the answers that differ (``wrong_batches`` of ``batches``,
``wrong_final``). The benchmark's own runs do not run it. Runs on the
first CUDA card, or with ``--device cpu`` on the CPU.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))  # the port, beside the benchmark


def control(workload: str, seed: int, dtypes, device: str = "cuda", overrides=None) -> list:
    """[{dtype, batches, wrong_batches, wrong_final, seconds}] per type."""
    import torch

    from harness import Cell, load_spec

    cell = Cell(load_spec(), workload, overrides)
    dev = torch.device(device)
    data = cell.ref.make_data(cell.cfg, seed, dev)
    bounds = cell.port.batch_bounds(cell.cfg, cell.traffic)
    ref = cell.ref.Reference(data, cell.cfg, bounds)
    exact = [ref.batch_answer(i) for i in range(len(bounds))]
    want_final = ref.final_answer(exact)
    out = []
    for name in dtypes:
        t0 = time.perf_counter()
        got = [cell.ref.control_answer(ref, i, getattr(torch, name)) for i in range(len(bounds))]
        out.append({"workload": workload, "seed": seed, "dtype": name, "batches": len(bounds),
                    "wrong_batches": sum(g != w for g, w in zip(got, exact)),
                    "wrong_final": int(ref.final_answer(got) != want_final),
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dtypes", default="float64,float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for line in control(args.workload, args.seed, args.dtypes.split(","), args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
