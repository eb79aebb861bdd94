"""The port's sprtcheck core (its own copy of the JAX package's
``analysis/core.py``): source model, rule registry, suppressions,
discovery and the per-file result cache.

A rule is a callable ``check(mod: SourceModule) -> Iterable[Finding]``
registered under a kebab-case name. Findings are silenced inline, at
the site: ``# sprtcheck: disable=rule1,rule2 — reason`` (same line, or
the comment line directly above). The port keeps no baseline: its tree
is clean or the gate fails. By default the analyzer scans the port's
package only (``DEFAULT_PATHS``); ``include_tests`` adds the port's own
test files (``TEST_GLOB``).
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import glob
import hashlib
import json
import os
import re
import tokenize
from typing import Callable, Dict, List, Optional, Sequence

# --------------------------------------------------------------------
# findings

SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str  # repo-relative posix path
    line: int
    col: int
    message: str
    snippet: str = ""

    def sort_key(self):
        return (self.file, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------
# rule registry

RULES: "Dict[str, _Rule]" = {}


@dataclasses.dataclass
class _Rule:
    name: str
    summary: str
    motivation: str
    check: Callable  # check(SourceModule)


def rule(name: str, summary: str, motivation: str = ""):
    """Register a per-module rule."""

    def deco(fn):
        RULES[name] = _Rule(name, summary, motivation, fn)
        return fn

    return deco


# --------------------------------------------------------------------
# source model

# rule list = kebab-case names, comma-separated; the capture stops at
# the first token that isn't one so any justification style works
# ("— why", "-- why", "why") without leaking into the rule names
_DISABLE_RE = re.compile(r"#\s*sprtcheck:\s*disable=(.*)")
_DISABLE_FILE_RE = re.compile(r"#\s*sprtcheck:\s*disable-file=(.*)")

_RULE_TOKEN_RE = re.compile(r"\s*([\w\-]+)")
_COMMA_RE = re.compile(r"\s*,")
# what may legally follow a rule name: end of comment, another comma,
# or a justification separator — NOT bare prose
_AFTER_RULE_RE = re.compile(r"\s*($|[,#—–-])")


def _parse_rule_list(s: str) -> frozenset:
    """Rule names after ``disable=``. The first token is always a
    rule; a comma-continuation token counts only when it is a
    REGISTERED rule name followed by end/comma/separator — a
    justification word that happens to name a rule
    (``disable=tracer-bool, data-dep-shape is handled below``) must
    not silently suppress that rule."""
    names = []
    pos = 0
    while True:
        m = _RULE_TOKEN_RE.match(s, pos)
        if not m:
            break
        tok = m.group(1)
        if names and (
            (RULES and tok not in RULES)
            or not _AFTER_RULE_RE.match(s, m.end())
        ):
            break  # justification text, not a rule name
        names.append(tok)
        nxt = _COMMA_RE.match(s, m.end())
        if not nxt:
            break
        pos = nxt.end()
    return frozenset(names)


class SourceModule:
    """One parsed Python file plus its suppression map."""

    def __init__(self, root: str, path: str):
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        self.parts = tuple(self.rel.split("/"))
        self.syntax_error: Optional[SyntaxError] = None
        try:
            # tokenize.open honors PEP 263 coding declarations — a
            # legally encoded latin-1 file must parse, not crash the
            # gate with a UnicodeDecodeError traceback
            with tokenize.open(path) as f:
                self.text = f.read()
        except (UnicodeDecodeError, SyntaxError) as e:
            self.text = ""
            self.syntax_error = SyntaxError(f"undecodable source: {e}")
            self.syntax_error.lineno = 1
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        if self.syntax_error is None:
            try:
                self.tree = ast.parse(self.text, filename=self.rel)
            except SyntaxError as e:
                self.syntax_error = e
        self._file_disables: frozenset = frozenset()
        self._line_disables: Dict[int, frozenset] = {}
        self._scan_suppressions()

    def _scan_suppressions(self):
        file_d = set()
        for i, line in enumerate(self.lines, 1):
            m = _DISABLE_FILE_RE.search(line)
            if m and line.lstrip().startswith("#"):
                file_d |= _parse_rule_list(m.group(1))
                continue
            m = _DISABLE_RE.search(line)
            if m:
                rules = _parse_rule_list(m.group(1))
                self._line_disables.setdefault(i, frozenset())
                self._line_disables[i] |= rules
                # a comment-only directive line covers the next line
                if line.lstrip().startswith("#"):
                    self._line_disables.setdefault(i + 1, frozenset())
                    self._line_disables[i + 1] |= rules
        self._file_disables = frozenset(file_d)

    def suppressed(self, rule_name: str, line: int) -> bool:
        if rule_name in self._file_disables:
            return True
        return rule_name in self._line_disables.get(line, frozenset())

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule_name: str, node_or_line, message: str) -> Finding:
        if isinstance(node_or_line, int):
            line, col = node_or_line, 0
        else:
            line = getattr(node_or_line, "lineno", 1)
            col = getattr(node_or_line, "col_offset", 0)
        return Finding(
            rule=rule_name,
            file=self.rel,
            line=line,
            col=col,
            message=message,
            snippet=self.snippet(line),
        )

    def in_dirs(self, *names: str) -> bool:
        """True when any path segment matches (``ops``, ``parallel``,
        ...) — works for the real package layout and for fixture
        corpora laid out as bare ``ops/x.py``."""
        return any(n in self.parts[:-1] for n in names)


# --------------------------------------------------------------------
# discovery + runner

_EXCLUDED_DIRS = {
    ".git",
    "__pycache__",
    ".claude",
    "build",
    "dist",
    ".ruff_cache",
    ".pytest_cache",
    # environments / vendored trees: never analyze third-party code —
    # in_dirs() matches any path segment, so a dependency shipping an
    # ops/ directory would otherwise hard-fail the gate
    ".venv",
    "venv",
    ".tox",
    ".eggs",
    "node_modules",
    "site-packages",
}


def default_root() -> str:
    """Repo root = parent of the installed package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


# what a run with no paths scans: the port's package, nothing else
DEFAULT_PATHS = ("spark_rapids_jni_tpu_torch",)
# the port's own tests, which a run with no paths adds under include_tests
TEST_GLOB = "tests/test_torch_*.py"


def discover(
    root: str,
    paths: Optional[Sequence[str]] = None,
    include_tests: bool = False,
) -> List[str]:
    """The ``.py`` files under ``paths`` (default: the root), leaving
    out every ``tests`` directory unless ``include_tests``."""
    roots = [os.path.join(root, p) for p in paths] if paths else [root]
    out = []
    for r in roots:
        if os.path.isfile(r):
            out.append(r)
            continue
        for dirpath, dirnames, filenames in os.walk(r):
            dirnames[:] = sorted(
                d
                for d in dirnames
                if d not in _EXCLUDED_DIRS
                and (include_tests or d != "tests")
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def _check_one_module(
    mod: SourceModule, rule_names: Sequence[str]
) -> List[Finding]:
    """Per-module rules on one parsed file, suppression-filtered.
    This is the unit the content-hash cache memoizes: everything it
    reads comes from the module's own text (suppressions included), so
    a text hash is a sound cache key."""
    if mod.syntax_error is not None:
        return [
            Finding(
                rule="parse-error",
                file=mod.rel,
                line=mod.syntax_error.lineno or 1,
                col=(mod.syntax_error.offset or 1) - 1,
                message=f"syntax error: {mod.syntax_error.msg}",
            )
        ]
    out: List[Finding] = []
    for name in rule_names:
        for f in RULES[name].check(mod):
            if not mod.suppressed(f.rule, f.line):
                out.append(f)
    return out


# --------------------------------------------------------------------
# per-file result cache: keyed on the file's content hash
# plus a fingerprint of the analyzer itself, so editing any rule (or
# this module) invalidates everything while an untouched source file
# re-analyzes for free. Only per-module rules cache — repo-wide rules
# read several surfaces at once and always run.

CACHE_VERSION = 1
_fingerprint_memo: Optional[str] = None


def rules_fingerprint() -> str:
    """sha1 over every analyzer source file (this package), memoized
    per process."""
    global _fingerprint_memo
    if _fingerprint_memo is None:
        pkg = os.path.dirname(os.path.abspath(__file__))
        h = hashlib.sha1()
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__"
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    p = os.path.join(dirpath, fn)
                    h.update(fn.encode())
                    with open(p, "rb") as f:
                        h.update(f.read())
        _fingerprint_memo = h.hexdigest()
    return _fingerprint_memo


def _load_cache(path: str, fingerprint: str, rule_names) -> Dict[str, dict]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if (
        not isinstance(data, dict)
        or data.get("version") != CACHE_VERSION
        or data.get("fingerprint") != fingerprint
        or data.get("rules") != list(rule_names)
    ):
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def _write_cache(
    path: str, fingerprint: str, rule_names, entries: Dict[str, dict]
) -> None:
    data = {
        "version": CACHE_VERSION,
        "fingerprint": fingerprint,
        "rules": list(rule_names),
        "entries": entries,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        # the cache is an accelerator, never a failure mode
        with contextlib.suppress(OSError):
            os.unlink(tmp)


def analyze(
    root: str,
    paths: Optional[Sequence[str]] = None,
    include_tests: bool = False,
    only_rules: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
) -> List[Finding]:
    """Run every registered rule over ``paths`` (default: the port's
    package, and with ``include_tests`` the port's test files); returns
    sorted, suppression-filtered findings.

    ``cache_path`` arms the content-hash result cache."""
    from . import rules as _rules  # noqa: F401 — ensure registration

    root = os.path.abspath(root)
    files = discover(root, paths or DEFAULT_PATHS, include_tests)
    if include_tests and not paths:
        files = sorted(set(files) | set(glob.glob(os.path.join(root, TEST_GLOB))))
    modules = [SourceModule(root, p) for p in files]
    per_module_names = sorted(
        name for name in RULES if only_rules is None or name in only_rules
    )

    # the cache is a FULL-TREE artifact: a path- or rule-scoped run
    # must neither read it (its rule list would mismatch anyway) nor
    # rewrite it — writing the subset would prune every out-of-scope
    # entry as "vanished" and the next full run would repay the whole
    # cold-analysis cost
    if paths is not None or only_rules is not None:
        cache_path = None

    findings: List[Finding] = []
    fingerprint = rules_fingerprint()
    cache_entries: Dict[str, dict] = (
        _load_cache(cache_path, fingerprint, per_module_names)
        if cache_path
        else {}
    )
    cache_dirty = False
    for mod in modules:
        key = hashlib.sha1(mod.text.encode("utf-8", "replace")).hexdigest()
        ent = cache_entries.get(mod.rel)
        cached: Optional[List[Finding]] = None
        if isinstance(ent, dict) and ent.get("key") == key:
            try:
                cached = [Finding(**d) for d in ent["findings"]]
            except (TypeError, KeyError):
                cached = None  # malformed entry: a miss, never a crash
        if cached is not None:
            findings.extend(cached)
            continue
        fs = _check_one_module(mod, per_module_names)
        findings.extend(fs)
        if cache_path:
            cache_entries[mod.rel] = {
                "key": key,
                "findings": [f.to_dict() for f in fs],
            }
            cache_dirty = True

    if cache_path and cache_dirty:
        # prune entries for files that vanished from the tree
        live = {m.rel for m in modules}
        cache_entries = {
            rel: e for rel, e in cache_entries.items() if rel in live
        }
        _write_cache(
            cache_path, fingerprint, per_module_names, cache_entries
        )

    return sorted(findings, key=Finding.sort_key)


# --------------------------------------------------------------------
# rendering

# ``new`` is every finding: the port keeps no baseline to grandfather
# any (the JAX renderers' ``grandfathered`` and ``stale``)

def render_text(new: Sequence[Finding]) -> str:
    out = []
    for f in new:
        out.append(f"{f.file}:{f.line}:{f.col + 1}: {f.rule}: {f.message}")
        if f.snippet:
            out.append(f"    {f.snippet}")
    counts: Dict[str, int] = {}
    for f in new:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    summary = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    if new:
        out.append(f"sprtcheck (port): {len(new)} finding(s) [{summary}]")
    else:
        out.append("sprtcheck (port): clean")
    return "\n".join(out)


def render_sarif(new: Sequence[Finding]) -> str:
    """SARIF 2.1.0, the CI-annotation interchange format, as the JAX
    package's ``render_sarif`` writes it, under the port's rule
    catalog: each finding a result of level ``error``."""
    from . import rules as _rules  # noqa: F401 — ensure registration

    rule_ids = sorted({f.rule for f in new} | set(RULES))
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    rules_meta = []
    for rid in rule_ids:
        r = RULES.get(rid)
        meta = {
            "id": rid,
            "shortDescription": {"text": r.summary if r else "sprtcheck finding"},
        }
        if r and r.motivation:
            meta["help"] = {"text": r.motivation}
        rules_meta.append(meta)
    results = []
    for f in new:
        region = {"startLine": max(f.line, 1), "startColumn": f.col + 1}
        if f.snippet:
            region["snippet"] = {"text": f.snippet}
        results.append({
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            # a repo-relative URI, no uriBaseId: consumers resolve it
            # against the checkout root
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.file},
                "region": region,
            }}],
        })
    run = {
        "tool": {"driver": {
            "name": "sprtcheck (port)",
            "informationUri": "docs/PORT_SPRTCHECK.md",
            "rules": rules_meta,
        }},
        "results": results,
    }
    return json.dumps(
        {
            "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
            "version": "2.1.0",
            "runs": [run],
        },
        indent=2,
    )


def render_json(new: Sequence[Finding]) -> str:
    return json.dumps(
        {
            "version": SCHEMA_VERSION,
            "findings": [f.to_dict() for f in new],
            "counts": {
                r: sum(1 for f in new if f.rule == r)
                for r in sorted({f.rule for f in new})
            },
        },
        indent=2,
    )
