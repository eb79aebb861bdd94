"""The integer cast kernel's time split into its parts, on one card.

    python3 scripts/int_cast_parts.py TREE

TREE is the root of a checkout of this repository. Beside it, under
TREE/build/int_parts/, three copies are patched: ``launch`` returns from
the kernel at once (the wrapper's two status memsets and the launch of
the persistent grid remain), ``staging`` parses no string (each row's
value is its first staged byte plus its length: the tile staging, the
loop over a tile's rows and the stores remain), and ``bytewise`` parses
the staged rows a byte at a time, as the rows in place are (no
eight-byte digit runs; the same results). In turns (the tree, launch,
staging, bytewise, bytewise, staging, launch, the tree), a fresh
interpreter in each builds its plugin and times ``native.cast_integer``
as ``native_ab.py`` does (phase 11's strings at 1 Mi rows to INT64, one
store_sales row group to INT32). The staging copy computes wrong values
on purpose, the launch copy none; the tree's and the bytewise copy's
results are held to the plain version. Prints one JSON line per run, then the card's line.
"""

import os
import sys

import float_cast_parts
import native_ab

KERNELS = os.path.join(float_cast_parts.NATIVE, "kernels.cu")
PARSE = """      IntParse p = o1 <= span_end ? parse_integer<true>(staged + (o0 - base), o1 - o0, in_valid,
                                                        Bits, ansi, Strip)"""
PATCHES = {
    "launch": (KERNELS, """  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int32_t R = kIntTileRows;""", """  if (n > 0) return;
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int32_t R = kIntTileRows;"""),
    "staging": (KERNELS, PARSE + """
                                  : parse_integer<false>(chars + o0, o1 - o0, in_valid, Bits,
                                                         ansi, Strip);""",
                """      IntParse p = {(int64_t)(o1 <= span_end ? staged[o0 - base] : chars[o0]) + (o1 - o0),
                    in_valid};"""),
    "bytewise": (KERNELS, PARSE, PARSE.replace("parse_integer<true>", "parse_integer<false>")),
}


def main(tree: str) -> int:
    tree = os.path.abspath(tree)
    copies = {name: float_cast_parts.patched(tree, name, PATCHES, "int_parts")
              for name in PATCHES}
    order = [tree, copies["launch"], copies["staging"], copies["bytewise"], copies["bytewise"],
             copies["staging"], copies["launch"], tree]
    return native_ab.run([(path, "int", "check" if path in (tree, copies["bytewise"]) else "-")
                          for path in order])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
