"""The float cast kernel's time split into its parts, on one card.

    python3 scripts/float_cast_parts.py TREE

TREE is the root of a checkout of this repository. Beside it, under
TREE/build/float_parts/, two copies are patched: ``staging`` parses no
string (each row's value is its first staged byte plus its length: the
tile staging, the loop over a tile's rows and the stores remain), and
``no_value`` parses every string but skips the value step (the digits
converted as they are: no power of ten, no division). In turns (the
tree, staging, no_value, no_value, staging, the tree), a fresh
interpreter in each builds its plugin and times ``native.cast_float64``
as ``native_ab.py`` does (1 Mi rows and one 16 Mi-row chunk). The
copies compute wrong values on purpose: only the tree's results are
held to the plain version. Prints one JSON line per run, then the
card's line.
"""

import os
import shutil
import sys

import native_ab

NATIVE = os.path.join("spark_rapids_jni_tpu_torch", "kernels", "csrc", "native")
PATCHES = {
    "staging": (os.path.join(NATIVE, "kernels.cu"), """        FloatParse p = o1 <= span_end
                           ? parse_float<true>(staged + (o0 - o[0]), len, in_valid, tab)
                           : parse_float<false>(chars + o0, len, in_valid, tab);""",
                """        FloatParse p = {(double)(o1 <= span_end ? staged[o0 - o[0]] : chars[o0]) + len,
                        len > 0, false};"""),
    "no_value": (os.path.join(NATIVE, "sprt_rowops.h"), """  // the value, in float64 (each operation rounded on its own)
  int32_t exp_ten = (int32_t)(exp_base + manual_exp);""",
                 """  out.value = (double)(int64_t)digits + exp_base + manual_exp;
  return out;
  int32_t exp_ten = (int32_t)(exp_base + manual_exp);"""),
}
SKIP = shutil.ignore_patterns("build", ".git", "__pycache__")


def patched(tree: str, name: str, patches=PATCHES, folder: str = "float_parts") -> str:
    """A copy of ``tree`` under TREE/build/``folder``/ with the part
    ``patches[name]`` names taken out."""
    dst = os.path.join(tree, "build", folder, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree, dst, ignore=SKIP)
    path, old, new = patches[name]
    with open(os.path.join(dst, path)) as fh:
        src = fh.read()
    if old not in src:
        raise SystemExit(f"{path} no longer holds the code the {name} copy takes out")
    with open(os.path.join(dst, path), "w") as fh:
        fh.write(src.replace(old, new))
    return dst


def main(tree: str) -> int:
    tree = os.path.abspath(tree)
    copies = {name: patched(tree, name) for name in PATCHES}
    order = [tree, copies["staging"], copies["no_value"], copies["no_value"],
             copies["staging"], tree]
    return native_ab.run([(path, "float", "check" if path == tree else "-") for path in order])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
