"""Phase 29 of chip_smoke.py (the serving driver) in two source trees,
in turns, on one card, each from a cleared plan cache.

    python3 scripts/serving_ab.py [--out DIR] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (two commits
unpacked side by side; give them as A B B A). For each, in order, a
fresh interpreter with TREE first on its path builds the port's
libraries, runs the phases phase 29 needs (q5 at SF10, the SF10
store_sales file, the q1 pipeline), clears the plan cache, collects
garbage and empties the allocator, and runs ``serving_phase``. Each
run's output goes to ``DIR/serving_ab_<i>.log`` (``build/serving_ab``
under the repo unless ``--out`` names another); the summary
prints one JSON line per run: the counted round's wall and rows/s and
each tenant's plan build (wall, and where the tree records them the
warm-up's and the capture's host walls), then the card's line.
"""

import json
import os
import re
import subprocess
import sys

CHILD = r"""
import gc, json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
from spark_rapids_jni_tpu_torch.kernels import _build, murmur3
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

_build.build(*(_build.kernel_sources() + sorted(_build.HOST_SOURCES)))
card = c.card_line()
counters = {"murmur3_chain": murmur3}
_, q5_ctx = c.q5_sf10(counters, card)
tmp = tempfile.mkdtemp(prefix="serving_ab-", dir=os.path.join(os.getcwd(), "build"))
ss_path = os.path.join(tmp, "store_sales.parquet")
_, ss_oracles = c.store_sales_sf10(counters, card, ss_path)
_, q1_ctx = c.q1_pipeline_phase(counters, card)
pl.plan_cache_clear()
gc.collect()
torch.cuda.synchronize()
torch.cuda.empty_cache()
t0 = time.perf_counter()
c.serving_phase(counters, card, q1_ctx, q5_ctx, ss_path, ss_oracles, tmp)
print(f"serving_ab: phase 29 {time.perf_counter() - t0:.1f} s wall", flush=True)
"""

ROUND = re.compile(r"counted round ([0-9.]+) ms, ([0-9.e+]+) rows/s")
TENANT = re.compile(r"^serving \[([a-z0-9_]+)\]: (\{.*\})$")


def summary(i: int, tree: str, text: str, rc: int) -> dict:
    got = {"run": i, "tree": tree, "rc": rc}
    m = ROUND.search(text)
    if m:
        got["round_ms"], got["rows/s"] = float(m.group(1)), float(m.group(2))
    for line in text.splitlines():
        t = TENANT.match(line)
        if t:
            got.setdefault("plan_build_ms", {})[t.group(1)] = json.loads(t.group(2))["plan_build_ms"]
        if line.startswith("serving_ab: phase 29"):
            got["phase_s"] = float(line.split()[3])
    return got


def main(trees, out_dir) -> int:
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rows = []
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=os.path.abspath(tree),
                              capture_output=True, text=True)
        with open(os.path.join(out_dir, f"serving_ab_{i}.log"), "w") as f:
            f.write(proc.stdout + "\n---- stderr\n" + proc.stderr)
        rows.append(summary(i, tree, proc.stdout, proc.returncode))
        print(json.dumps(rows[-1]), flush=True)
    print(card.strip(), flush=True)
    return max(r["rc"] for r in rows)


if __name__ == "__main__":
    args = sys.argv[1:]
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "build", "serving_ab")
    if args[:1] == ["--out"] and len(args) > 1:
        out, args = args[1], args[2:]
    if not args:
        sys.exit(__doc__)
    sys.exit(main(args, out))
