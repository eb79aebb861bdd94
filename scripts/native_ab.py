"""The native plugin's decimal128, cast_float64 and cast_integer kernels
timed in several source trees, in turns, on one card.

    python3 scripts/native_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (two commits
unpacked side by side; give them as A B B A). For each, in order, a
fresh interpreter with TREE first on its path builds that tree's CUDA
plugin and times that tree's wrappers (``kernels/native.py``) on the
same seeded inputs: decimal128 multiply (2, 2 -> 4), q1's, and add (3,
2, 2), a dividing regime, over 4 Mi q1 rows (``chip_smoke.py`` phase
33's operands), and cast_float64 over the reference's toFloat strings
at 1 Mi rows (phase 33's column) and one 16 Mi-row chunk (phase 14's
first), and cast_integer over phase 11's integer strings at 1 Mi rows
to INT64 (phase 33's column) and over one store_sales row group's
quantity strings to INT32 (2 Mi rows of "  qq ", the main path's shape).
Each result is first held bit for bit to the tree's plain version;
each time is the tree's ``launch_medians`` (the median of 25 launches
in each of three loops). Prints one JSON line per run, then the card's
line.
"""

import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as c
from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy
from spark_rapids_jni_tpu_torch.kernels import native

rng = np.random.default_rng(42)
q1 = c.q1_batch_arrays(rng, c.N_MAIN)
valid = torch.from_numpy(rng.random(c.N_MAIN) > 0.02).cuda()


def limbs(x):
    x = torch.from_numpy(x).cuda()
    return torch.stack([x, x >> 63], dim=-1).contiguous()


a, b = limbs(q1["price"]), limbs(100 - q1["disc"])
out = {"tree": os.getcwd()}
kernels, check = sys.argv[1], sys.argv[2] == "check"


def timed(label, kernel, plain):
    if check:
        for g, w in zip(c.flat_tensors(kernel()), c.flat_tensors(plain())):
            c.same_bytes(label, g, w)
    torch.cuda.synchronize()
    out[label] = c.launch_medians(kernel)


for op, sc in (("mul", (2, 2, 4)), ("add", (3, 2, 2))) if kernels == "all" else ():
    timed(f"decimal128 {op} {sc}",
          lambda op=op, sc=sc: native.decimal128(op, a, b, valid, None, *sc),
          lambda op=op, sc=sc: native.decimal128_plain(op, a, b, valid, None, *sc))
if kernels in ("all", "int"):
    ints = column_from_numpy(c.int_cast_spec(c.N_WIDE), "cuda")
    qty = column_from_numpy(c.string_column_spec(
        [f"  {v} " for v in c.ss_gen_chunk(c.SS_RG, 1000)["qty_i"]]), "cuda")
    for label, col, bits in (("1 Mi int64", ints, 64), ("store_sales int32", qty, 32)):
        timed(f"cast_integer {label}",
              lambda col=col, bits=bits: native.cast_integer(col.data, col.offsets, col.validity,
                                                             bits, False, True),
              lambda col=col, bits=bits: native.cast_integer_plain(col.data, col.offsets,
                                                                   col.validity, bits, False,
                                                                   True))
    del ints, qty
for n, seed in ((1 << 20, 21), (1 << 24, 100)) if kernels in ("all", "float") else ():
    spec, _ = c.float_axis_strings(n, seed)
    col = column_from_numpy(spec, "cuda")
    timed(f"cast_float64 {n}",
          lambda col=col: native.cast_float64(col.data, col.offsets, col.validity),
          lambda col=col: native.cast_float64_plain(col.data, col.offsets, col.validity))
    del col
print("AB " + json.dumps(out), flush=True)
"""


def run(runs) -> int:
    """Each (tree, kernels, check) in turn in a fresh interpreter
    (kernels: "all", "float" or "int"; check: "check" holds each result
    to its plain version first): its JSON line, then the card's line."""
    for tree, kernels, check in runs:
        proc = subprocess.run([sys.executable, "-c", CHILD, kernels, check],
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1][3:], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(run([(tree, "all", "check") for tree in sys.argv[1:]]))
