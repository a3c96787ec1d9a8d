"""repro_torch.analysis.lint: the torchlint rules fire on exactly the lines
their seeded fixtures mark and stay silent on the clean variants and on
the port's tree; pragmas suppress and record; the CLI's report has the
reference's keys; the helpers copied from the reference's jaxlint agree
with it; TL005 fires on each in-place kernel's launch without its version
bump (a verbatim copy of the Langevin update's launch before the bump, and
the three wrappers with their bumps taken out)."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import lint as tl
from repro_torch.analysis.lint import (
    REFERENCE,
    RULES,
    lint_file,
    lint_paths,
    lint_source,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torchlint"
JAX_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jaxlint"
CLI = REPO / "scripts" / "torch_lint.py"
PORT_TREE = ([REPO / "src" / "repro_torch"] + sorted(REPO.glob("examples/torch_*.py"))
             + sorted(REPO.glob("scripts/torch_*.py")) + [REPO / "chip_smoke.py"])


def _expected(path: Path) -> set:
    """{(rule, line)} of the fixture's ``# expect: TL00N`` markers."""
    return {(m.group(1), i) for i, line in enumerate(path.read_text().splitlines(), 1)
            for m in [re.search(r"# expect: (TL\d{3})", line)] if m}


def _active(findings) -> set:
    return {(f.rule, f.line) for f in findings if not f.suppressed}


# -- the seeded fixtures ----------------------------------------------------

@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_fires_on_seeded_violation(rule):
    path = FIXTURES / f"{rule.lower()}_bad.py"
    want = _expected(path)
    assert want and {r for r, _ in want} == {rule}
    findings = lint_file(path)
    assert _active(findings) == want, [f.format() for f in findings]


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_silent_on_clean_variant(rule):
    findings = lint_file(FIXTURES / f"{rule.lower()}_good.py")
    assert not findings, [f.format() for f in findings]


def test_inline_pragma_suppresses_but_records():
    findings = lint_file(FIXTURES / "pragma_suppressed.py")
    assert findings, "the pragma fixture's seeded violations went undetected"
    assert all(f.suppressed for f in findings), \
        [f.format() for f in findings if not f.suppressed]
    assert {f.rule for f in findings} == {"TL003", "TL004"}


def test_file_wide_pragma():
    findings = lint_file(FIXTURES / "pragma_file_wide.py")
    tl003 = [f for f in findings if f.rule == "TL003"]
    assert tl003 and all(f.suppressed for f in tl003)
    # the pragma is per rule: another rule in the same file stays live
    src = (FIXTURES / "pragma_file_wide.py").read_text() + (
        "\n\nimport torch\n\n\ndef init(shape):\n    return torch.randn(shape)\n")
    assert not [f for f in lint_source(src) if not f.suppressed and f.rule != "TL003"]
    src += "\n\n@torch.compile\ndef loss(e):\n    return e.sum().item()\n"
    assert [f.rule for f in lint_source(src) if not f.suppressed] == ["TL004"]


def test_syntax_error_reported_not_raised(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    assert [f.rule for f in lint_file(bad)] == ["TL000"]


@pytest.mark.parametrize("imports,draw,uniform", [
    ("from repro_torch.kernels import rng as jr", "jr.jax_normal", "jr.jax_uniform"),
    ("import repro_torch.kernels.rng as r", "r.jax_normal", "r.jax_uniform"),
    ("from repro_torch.kernels.rng import jax_normal as n, jax_uniform as u", "n", "u"),
])
def test_import_alias_resolution(imports, draw, uniform):
    src = (f"{imports}\n"
           "def sample(key, shape):\n"
           f"    a = {draw}(key, shape)\n"
           f"    b = {uniform}(key, shape)\n"
           "    return a + b\n")
    assert [(f.rule, f.line) for f in lint_source(src)] == [("TL003", 4)]
    # an unrelated module's function of the same name is no rng draw
    other = src.replace(imports, "from mylib import jax_normal, jax_uniform")
    other = other.replace(f"{draw}(", "jax_normal(").replace(f"{uniform}(", "jax_uniform(")
    assert lint_source(other) == []


def test_rules_pair_with_reference():
    """Each TL00N is the counterpart of one reference rule JL00N; the
    reference's rule table is read from its source, not imported."""
    tree = ast.parse((REPO / "src" / "repro" / "analysis" / "lint.py").read_text())
    ref_rules = next(ast.literal_eval(n.value) for n in tree.body
                     if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "RULES")
    assert set(REFERENCE) == set(RULES)
    assert sorted(REFERENCE.values()) == sorted(ref_rules)
    assert all(k[2:] == v[2:] for k, v in REFERENCE.items())


# -- the port's tree and the CLI ---------------------------------------------

def test_port_tree_is_clean():
    """The port's gate: ``scripts/torch_lint.py`` over the port's tree
    exits 0 with no active finding; every suppression carries a reason."""
    proc = subprocess.run([sys.executable, str(CLI), *map(str, PORT_TREE)],
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    for f in [f for f in lint_paths(PORT_TREE) if f.suppressed]:
        lines = Path(f.path).read_text().splitlines()
        after = re.search(r"disable=TL\d{3}(.*)", lines[f.line - 1]).group(1)
        above = [ln.strip() for ln in lines[max(0, f.line - 4):f.line - 1]]
        assert after.strip() or any(ln.startswith("#") for ln in above), \
            f"{f.format()}: a suppression without a reason"


def test_cli_baseline_json():
    proc = subprocess.run([sys.executable, str(CLI), "--baseline", str(FIXTURES)],
                          capture_output=True, text=True, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert set(report) == {"rules", "findings", "counts"}
    assert report["rules"] == RULES
    assert report["counts"]["active"] > 0  # the seeded violations
    assert report["counts"]["suppressed"] >= 3  # the pragma fixtures
    assert set(RULES) <= {f["rule"] for f in report["findings"]}


def test_cli_exits_nonzero_on_findings():
    proc = subprocess.run([sys.executable, str(CLI), str(FIXTURES / "tl003_bad.py")],
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 1
    assert "TL003" in proc.stdout
    proc = subprocess.run([sys.executable, str(CLI), "--select", "TL001",
                           str(FIXTURES / "tl003_bad.py")],
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout


# -- the helpers copied from the reference -----------------------------------

def _to_port(text: str) -> str:
    return text.replace("jaxlint", "torchlint").replace("JL0", "TL0").replace("jl0", "tl0")


def _pragma_sources():
    srcs = [(p.name, p.read_text()) for p in sorted(JAX_FIXTURES.glob("pragma_*.py"))]
    srcs.append(("all-and-lists", "x = 1  # jaxlint: disable=JL001, jl004\n"
                                  "# jaxlint: disable-file=all\n"
                                  "y = '# jaxlint: disable=JL002'\n"))
    return srcs


def _port_sources():
    return [(str(p.relative_to(REPO)), p.read_text()) for p in
            [REPO / "src/repro_torch/kernels/langevin_update.py",
             REPO / "src/repro_torch/samplers/transforms.py",
             REPO / "src/repro_torch/launch/mesh.py", REPO / "chip_smoke.py"]]


@pytest.mark.parametrize("helper", ["_pragmas", "_import_aliases", "_dotted"])
def test_helpers_match_reference(helper):
    """The copied helpers give the reference's results: ``_pragmas`` on the
    reference's own pragma fixtures (the tool's name and rule prefix
    translated), ``_import_aliases`` and ``_dotted`` (every call's callee)
    on the port's sources."""
    from repro.analysis import lint as jl

    if helper == "_pragmas":
        for name, src in _pragma_sources():
            want_lines, want_file = jl._pragmas(src)
            got_lines, got_file = tl._pragmas(_to_port(src))
            assert got_lines == {k: {_to_port(r) for r in v}
                                 for k, v in want_lines.items()}, name
            assert got_file == {_to_port(r) for r in want_file}, name
        return
    for name, src in _port_sources():
        tree = ast.parse(src)
        aliases = jl._import_aliases(tree)
        assert tl._import_aliases(tree) == aliases, name
        if helper == "_dotted":
            calls = [n.func for n in ast.walk(tree) if isinstance(n, ast.Call)]
            assert calls
            assert [tl._dotted(c, aliases) for c in calls] == \
                [jl._dotted(c, aliases) for c in calls], name


# -- TL005 on the in-place kernels --------------------------------------------

def test_tl005_fires_on_langevin_launch_before_the_bump():
    findings = lint_file(FIXTURES / "tl005_langevin_before.py")
    assert [(f.rule, f.line) for f in findings] == sorted(_expected_launch(
        FIXTURES / "tl005_langevin_before.py", "langevin_update_launch"))
    assert "`x`" in findings[0].message


def test_tl005_known_miss_returns_nothing():
    """TL005 knows a written tensor only by the function handing it back:
    an in-place wrapper that returns None passes.  Pinned here, so a rule
    that learns it moves the fixture's marker from a known miss to an
    ``# expect:``."""
    path = FIXTURES / "tl005_bad.py"
    misses = {i for i, text in enumerate(path.read_text().splitlines(), 1)
              if "# known miss: TL005" in text}
    assert len(misses) == 1
    assert not [f for f in lint_file(path) if f.line in misses]


def _expected_launch(path: Path, launch: str) -> set:
    line = next(i for i, text in enumerate(path.read_text().splitlines(), 1)
                if f".{launch}(" in text)
    return {("TL005", line)}


@pytest.mark.parametrize("module,launch,written", [
    ("langevin_update.py", "langevin_update_launch", ["x"]),
    ("decode_step.py", "decode_step_launch", ["k_cache", "v_cache"]),
    ("decode_step.py", "paged_decode_step_launch", ["k_pages", "v_pages"]),
])
def test_tl005_guards_each_in_place_wrapper(module, launch, written):
    """The wrapper lints clean with its version bumps, and without them
    TL005 fires on its launch for each tensor it writes and hands back —
    and for nothing it only reads (q, g, table, tables, pos) or allocates
    (o, the scratch)."""
    path = REPO / "src" / "repro_torch" / "kernels" / module
    src = path.read_text()
    assert lint_source(src) == []
    stripped = "\n".join(
        line for line in src.splitlines()
        if "increment_version(" not in line or all(f"({w})" not in line for w in written))
    assert stripped != src
    line = next(i for i, text in enumerate(stripped.splitlines(), 1) if f".{launch}(" in text)
    hits = [f for f in lint_source(stripped) if f.line == line]
    assert [f.rule for f in hits] == ["TL005"] * len(written)
    assert sorted(re.search(r"writes `(\w+)`", f.message).group(1) for f in hits) == \
        sorted(written)
