"""The port's sprtcheck CLI: ``python -m spark_rapids_jni_tpu_torch.analysis``.

Exit codes: 0 clean, 1 findings, 2 bad invocation.
"""

from __future__ import annotations

import argparse
import os
import sys

from .core import RULES, analyze, default_root, render_json, render_sarif, render_text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis",
        description="sprtcheck for the port's torch code (docs/PORT_SPRTCHECK.md)",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs relative to --root (default: the port's package)")
    ap.add_argument("--root", default=None, help="repo root")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--sarif", action="store_true",
                    help="SARIF 2.1.0 output (CI annotation artifact)")
    ap.add_argument("--cache", nargs="?", const="", default=None, metavar="PATH",
                    help="per-file result cache keyed on content hash (default path when "
                    "given bare: <root>/.sprtcheck_torch_cache.json)")
    ap.add_argument("--include-tests", action="store_true",
                    help="analyze tests too (the port's tests/test_torch_*.py when no path "
                    "is given; excluded by default)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="NAME",
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    from . import rules as _rules  # noqa: F401

    if args.list_rules:
        for name in sorted(RULES):
            print(f"{name}: {RULES[name].summary}")
        return 0
    if args.json and args.sarif:
        print("sprtcheck: --json and --sarif are mutually exclusive", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or default_root())
    for p in args.paths:
        if not os.path.exists(os.path.join(root, p)):
            # a typo'd path scanning zero files would print "clean"
            print(f"sprtcheck: no such path under {root}: {p}", file=sys.stderr)
            return 2
    if args.rules:
        unknown = set(args.rules) - set(RULES)
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
    cache_path = None
    if args.cache is not None:
        cache_path = args.cache or os.path.join(root, ".sprtcheck_torch_cache.json")
    findings = analyze(root, paths=args.paths or None, include_tests=args.include_tests,
                       only_rules=args.rules, cache_path=cache_path)
    render = render_json if args.json else render_sarif if args.sarif else render_text
    print(render(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
