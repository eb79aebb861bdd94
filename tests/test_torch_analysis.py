"""The port's sprtcheck (spark_rapids_jni_tpu_torch/analysis): fixture
corpora per rule, each with a passing and a failing case; a seeded
``.item()`` two calls under a dispatch-path function, which the JAX
analyzer passes and the port's analyzer flags with its call chain; the
taint model on single expressions; the rule table in
docs/PORT_SPRTCHECK.md; and the port's own tree, which must be clean."""

import ast
import json
import os
import textwrap

import pytest

import spark_rapids_jni_tpu.analysis as jax_analysis
from spark_rapids_jni_tpu_torch.analysis import RULES, analyze, pyast
from spark_rapids_jni_tpu_torch.analysis.__main__ import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORPORA = {
    ("dispatch-sync-free", "pass"): ("runtime/prog.py", """
        import torch

        def _fill(occ):
            return torch.stack([o.sum() for o in occ]).max()

        # sprtcheck: dispatch-path
        def run(table, occ):
            if table.num_rows and len(occ):
                return _fill(occ).to(torch.int32)
            return None
        """),
    ("dispatch-sync-free", "fail"): ("runtime/prog.py", """
        import torch

        def _plan(occ):
            if torch.stack([o.sum() for o in occ]).max() > 8:
                return 2
            return 1

        # sprtcheck: dispatch-path
        def run(table, occ):
            return _plan(occ)
        """),
    ("graph-capture-sync", "pass"): ("ops/stage.py", """
        import torch
        from ._strategy import fused

        def keep(col, cap):
            idx = torch.arange(cap, device=col.data.device)
            return torch.where(col.validity_or_true(), col.data, 0)[idx]

        def width(col, pinned=None):
            if pinned is not None or fused():
                return pinned
            return int(col.offsets[-1])

        # sprtcheck: host-side — an error report after the op
        def bad_row(col, bad):
            return int(torch.argmax(bad.to(torch.uint8)))
        """),
    ("graph-capture-sync", "fail"): ("ops/stage.py", """
        import torch

        def keep(col):
            idx = torch.nonzero(col.validity_or_true()).squeeze(1)
            return col.data[idx]
        """),
    ("implicit-float-dtype", "pass"): ("ops/means.py", """
        import torch

        def means(n, dev):
            acc = torch.zeros(n, dtype=torch.float64, device=dev)
            ones = torch.full((n,), 1, dtype=torch.int64, device=dev)
            return acc, ones, torch.tensor([0.5, 2.0], dtype=torch.float64)
        """),
    ("implicit-float-dtype", "fail"): ("ops/means.py", """
        import torch

        def means(n, dev):
            return torch.zeros(n, device=dev)
        """),
    ("validity-mask-dtype", "pass"): ("ops/mask.py", """
        import torch
        from ..columnar.column import Column

        def masked(dt, data, valid):
            return Column(dt, data, valid.to(torch.bool))
        """),
    ("validity-mask-dtype", "fail"): ("ops/mask.py", """
        import torch
        from ..columnar.column import Column

        def masked(dt, data, valid):
            return Column(dt, data, validity=valid.to(torch.int8))
        """),
}


def _corpus(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return str(tmp_path)


@pytest.mark.parametrize("rule,case", sorted(CORPORA))
def test_rule_corpus(tmp_path, rule, case):
    rel, src = CORPORA[(rule, case)]
    root = _corpus(tmp_path, rel, src)
    found = analyze(root, paths=["."], only_rules=[rule])
    if case == "pass":
        assert found == []
        return
    assert len(found) == 1, found
    assert found[0].rule == rule and found[0].file == rel
    if rule == "dispatch-sync-free":
        # the finding names the call chain down to the sync site
        assert "run -> _plan -> `if` on a device value" in found[0].message


def test_seeded_item_two_calls_under_dispatch_path(tmp_path):
    src = """
        import torch

        def _count(occ: torch.Tensor):
            return occ.sum().item()

        def _size(occ):
            return _count(occ) + 1

        # sprtcheck: dispatch-path
        def run(table, occ):
            n = _size(occ)
            return table, n
        """
    root = _corpus(tmp_path, "runtime/seeded.py", src)
    # the JAX analyzer taints jnp values only: it sees no sync here
    assert jax_analysis.analyze(root, paths=["."], only_rules=["dispatch-sync-free"]) == []
    found = analyze(root, paths=["."], only_rules=["dispatch-sync-free"])
    assert [f.rule for f in found] == ["dispatch-sync-free"]
    assert "run -> _size -> _count -> .item() on a device value at line 5" in found[0].message


def test_suppression_at_the_site_with_a_reason(tmp_path):
    rel, src = CORPORA[("graph-capture-sync", "fail")]
    src = textwrap.dedent(src).replace(
        "    idx = torch.nonzero",
        "    # sprtcheck: disable=graph-capture-sync — an eager entry\n    idx = torch.nonzero")
    root = _corpus(tmp_path, rel, src)
    assert analyze(root, paths=["."]) == []


TAINT_CASES = {
    "x = col.offsets[-1]": True,
    "x = t.max()": True,
    "x = torch.ones(3).sum()": True,
    "x = col.data.shape[0] + len(col.data) + col.data.numel()": False,
    "x = [v is None for v in col.data]": False,
    "x = np.asarray(spec['data']).sum()": False,
}


@pytest.mark.parametrize("stmt", sorted(TAINT_CASES))
def test_taint_model(stmt):
    fn = ast.parse(f"def f(col, spec, t: torch.Tensor):\n    {stmt}\n").body[0]
    assert ("x" in pyast.device_tainted_names(fn)) is TAINT_CASES[stmt]


def test_cli_exit_codes(tmp_path, capsys):
    rel, src = CORPORA[("implicit-float-dtype", "fail")]
    root = _corpus(tmp_path, rel, src)
    assert main(["--root", root, "."]) == 1
    assert main(["--root", root, "no/such/dir"]) == 2
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "implicit-float-dtype" in out and "graph-capture-sync" in out


def test_cli_sarif(tmp_path, capsys):
    """--sarif: SARIF 2.1.0's required keys, one result for each finding
    of a seeded bad file; exit 2 beside --json."""
    src = CORPORA[("implicit-float-dtype", "fail")][1].replace(
        "return torch.zeros(n, device=dev)",
        "return torch.zeros(n, device=dev), torch.ones(n, device=dev)")
    root = _corpus(tmp_path, "ops/means.py", src)
    found = analyze(root, paths=["."])
    assert len(found) == 2
    capsys.readouterr()
    assert main(["--root", root, "--sarif", "."]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0" and doc["$schema"].endswith("sarif-2.1.0.json")
    (run,) = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] and {r["id"] for r in driver["rules"]} == set(RULES)
    assert len(run["results"]) == len(found)
    for res, f in zip(run["results"], found):
        assert res["ruleId"] == f.rule and res["message"]["text"] == f.message
        assert driver["rules"][res["ruleIndex"]]["id"] == f.rule
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"] == f.file
        assert loc["region"]["startLine"] == f.line
    assert main(["--root", root, "--json", "--sarif", "."]) == 2


def test_include_tests_changes_the_scan(tmp_path):
    """Tests stay out of a scan unless --include-tests; with it and no
    path, the port's own tests/test_torch_*.py join the package."""
    bad = CORPORA[("dispatch-sync-free", "fail")][1]
    root = _corpus(tmp_path, "spark_rapids_jni_tpu_torch/runtime/ok.py", "x = 1\n")
    for rel in ("tests/test_torch_x.py", "tests/test_other.py",
                "spark_rapids_jni_tpu_torch/tests/helper.py"):
        _corpus(tmp_path, rel, bad)
    assert analyze(root) == [] and main(["--root", root]) == 0
    found = analyze(root, include_tests=True)
    assert {f.file for f in found} == {
        "tests/test_torch_x.py", "spark_rapids_jni_tpu_torch/tests/helper.py"}
    assert main(["--root", root, "--include-tests"]) == 1
    # with a path, every tests directory under it
    assert analyze(root, paths=["."]) == []
    assert len(analyze(root, paths=["."], include_tests=True)) == 3


def test_result_cache_cold_and_warm(tmp_path, monkeypatch):
    from spark_rapids_jni_tpu_torch.analysis import core

    rel, src = CORPORA[("implicit-float-dtype", "fail")]
    root = _corpus(tmp_path, "spark_rapids_jni_tpu_torch/" + rel, src)
    cache = str(tmp_path / "cache.json")
    cold = analyze(root, cache_path=cache)
    assert [f.rule for f in cold] == ["implicit-float-dtype"] and os.path.exists(cache)
    checked = []
    real = core._check_one_module
    monkeypatch.setattr(core, "_check_one_module",
                        lambda mod, names: checked.append(mod.rel) or real(mod, names))
    # warm: every file is a hit, and the findings are the cold run's
    assert analyze(root, cache_path=cache) == cold and checked == []
    # an edited file misses and is analyzed again
    (tmp_path / "spark_rapids_jni_tpu_torch" / rel).write_text("x = 1\n")
    assert analyze(root, cache_path=cache) == [] and len(checked) == 1


def test_rule_table_names_every_jax_rule():
    with open(os.path.join(ROOT, "docs", "PORT_SPRTCHECK.md"), encoding="utf-8") as f:
        rows = [ln for ln in f if ln.startswith("| `")]
    cells = {}
    for row in rows:
        first, entry = row.split("|")[1:3]
        for name in first.replace("`", "").split(","):
            cells[name.strip()] = entry.strip()
    assert set(jax_analysis.RULES) <= set(cells)
    assert all(cells[name] for name in jax_analysis.RULES)
    table = "".join(rows)
    assert all(f"`{name}`" in table for name in RULES)


def test_port_tree_is_clean():
    found = analyze(ROOT)
    assert found == [], "\n".join(f"{f.file}:{f.line}: {f.rule}: {f.message}" for f in found)
    # the default scan is the port's package
    assert main(["--root", ROOT]) == 0
