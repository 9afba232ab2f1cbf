"""The port's analyzer, static half (``repro_torch.analysis``): each
rule's fixtures translated to the port's idioms (known-bad flagged,
known-good clean, waived with a reason, out of scope), the waiver
ledger's own rules, the reporters, the CLI's exit codes — held against
the reference's analyzer (``repro.analysis``) where the two mean the same
thing — and the gate: the port and its tests analyze clean.

Waiver comments inside fixture strings are built by concatenation, so
that neither analyzer's scan of this file's raw lines reads them as real
waivers.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import analyze_source as ref_analyze_source
from repro.analysis import render_json as ref_render_json
from repro.analysis.__main__ import main as ref_main
from repro_torch.analysis import analyze_paths, analyze_source, render_json
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.analysis.framework import all_rules

REPO = Path(__file__).resolve().parents[1]

HOT = "src/repro_torch/sparse/fixture.py"     # inside no-densify's scope
COLD = "src/repro_torch/launch/fixture.py"    # outside it
DATA = "src/repro_torch/data/fixture.py"      # inside exception-hygiene's
ALLOW = "# repro: " + "allow"                 # a waiver's opening


def active(findings, rule=None):
    out = [f for f in findings if not f.suppressed]
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


# ---------------------------------------------------------------------------
# no-densify
# ---------------------------------------------------------------------------

def test_no_densify_flags_the_ports_densifiers():
    src = (
        "import numpy as np\n"
        "def f(a: SpCSR, b: BSR, t):\n"
        "    w = a.toarray()\n"
        "    x = to_dense(a)\n"
        "    y = bsr_to_dense(b)\n"
        "    z = t.to_dense()\n"
        "    s = np.asarray(a)\n"
        "    return w, x, y, z, s\n"
    )
    found = active(analyze_source(src, path=HOT), "no-densify")
    assert [f.line for f in found] == [3, 4, 5, 6, 7]


def test_no_densify_flags_dense_allocation_from_sparse_shape():
    src = (
        "import torch\n"
        "def f(a: BSROperand):\n"
        "    n, m = a.shape\n"
        "    direct = torch.zeros(a.shape)\n"
        "    unpacked = torch.empty((n, m))\n"
        "    built = bsr_operand(a)\n"
        "    again = torch.full(built.shape, 1.0)\n"
        "    return direct, unpacked, again\n"
    )
    assert len(active(analyze_source(src, path=HOT), "no-densify")) == 3


def test_no_densify_good_code_passes():
    src = (
        "import torch\n"
        "def f(a: SpCSR, k: int):\n"
        "    n, m = a.shape\n"
        "    u = torch.zeros((n, k))\n"       # factor-width: fine
        "    d = torch.as_tensor([1.0])\n"    # not a sparse operand
        "    g = torch.gather(u, 1, a.cols.long())\n"
        "    return u, d, g\n"
    )
    assert not active(analyze_source(src, path=HOT), "no-densify")


@pytest.mark.parametrize("path,flagged", [
    (HOT, True), ("src/repro_torch/core/fixture.py", True),
    ("src/repro_torch/backend/fixture.py", True),
    ("src/repro_torch/kernels/fixture.py", True),
    ("src/repro_torch/data/corpus.py", True), (COLD, False),
    ("src/repro_torch/data/synthetic.py", False),
    ("src/repro/sparse/fixture.py", False)])
def test_no_densify_scoped_to_hot_packages(path, flagged):
    src = "def f(a: SpCSR):\n    return a.toarray()\n"
    assert bool(active(analyze_source(src, path=path), "no-densify")) \
        == flagged


def test_no_densify_suppressed_with_reason():
    src = ("def f(a: SpCSR):\n"
           "    return to_dense(a)  " + ALLOW
           + "[no-densify] tiny test oracle\n")
    findings = analyze_source(src, path=HOT)
    assert not active(findings)
    (sup,) = [f for f in findings if f.suppressed]
    assert sup.rule == "no-densify" and sup.reason == "tiny test oracle"


# ---------------------------------------------------------------------------
# psum-axis
# ---------------------------------------------------------------------------

def test_psum_axis_catches_typo_against_declared_axes():
    src = (
        "AXES = ('pod', 'data', 'model')\n"
        "def f(mesh, x):\n"
        "    good = mesh.all_reduce(x, 'data')\n"
        "    pair = mesh.all_reduce(x, ('pod', 'data'), op='max')\n"
        "    bad = mesh.all_reduce(x, 'modle')\n"
        "    also = mesh.all_to_all(x, axis='mdoel')\n"
        "    whole = mesh.gather(x, 8, 'dta', 1)\n"
        "    return good, pair, bad, also, whole\n"
    )
    msgs = [f.message for f in
            active(analyze_source(src, path=COLD), "psum-axis")]
    assert len(msgs) == 3
    for typo in ("'modle'", "'mdoel'", "'dta'"):
        assert any(typo in m for m in msgs), msgs


def test_psum_axis_ignores_non_axis_arguments():
    src = (
        "import torch\n"
        "import torch.distributed as dist\n"
        "AXES = ('data', 'model')\n"
        "def f(x, ids, g):\n"
        "    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)\n"
        "    return torch.gather(x, -1, ids)\n"
    )
    assert not active(analyze_source(src, path=COLD), "psum-axis")


def test_psum_axis_unverifiable_without_axes_declaration():
    src = "def f(mesh, x):\n    return mesh.all_reduce(x, 'anything')\n"
    (f,) = active(analyze_source(src, path=COLD), "psum-axis")
    assert "unverifiable" in f.message and "'anything'" in f.message


def test_psum_axis_defers_to_ir_checker():
    rule = all_rules()["psum-axis"]
    src = "def f(mesh, x):\n    return mesh.all_reduce(x, 'anything')\n"
    rule.defer_to_ir = True
    try:
        assert not active(analyze_source(src, path=COLD), "psum-axis")
    finally:
        rule.defer_to_ir = False


# ---------------------------------------------------------------------------
# exception-hygiene
# ---------------------------------------------------------------------------

BARE_AND_SWALLOWED = (
    "def f():\n"
    "    try:\n"
    "        g()\n"
    "    except:\n"
    "        pass\n"
    "    try:\n"
    "        g()\n"
    "    except Exception:\n"
    "        pass\n"
)

REPORTED_AND_NARROW = (
    "def f():\n"
    "    try:\n"
    "        g()\n"
    "    except OSError:\n"
    "        retry()\n"
    "    try:\n"
    "        g()\n"
    "    except Exception as exc:\n"
    "        raise ChunkPackError('ctx') from exc\n"
    "    try:\n"
    "        g()\n"
    "    except Exception as exc:\n"
    "        q.put((None, exc))\n"
    "    try:\n"
    "        g()\n"
    "    except Exception:\n"
    "        warnings.warn('degraded')\n"
)


def test_exception_hygiene_flags_bare_and_swallowed():
    findings = active(analyze_source(BARE_AND_SWALLOWED, path=DATA),
                      "exception-hygiene")
    assert len(findings) == 2
    assert "bare" in findings[0].message
    assert "swallows" in findings[1].message


def test_exception_hygiene_accepts_reported_and_narrow_handlers():
    assert not active(analyze_source(REPORTED_AND_NARROW, path=DATA),
                      "exception-hygiene")


@pytest.mark.parametrize("pkg,flagged", [
    ("core", True), ("backend", True), ("kernels", True), ("data", True),
    ("launch", False), ("serving", False)])
def test_exception_hygiene_scoped_to_core_packages(pkg, flagged):
    src = "def f():\n    try:\n        g()\n    except:\n        pass\n"
    path = f"src/repro_torch/{pkg}/fixture.py"
    assert bool(active(analyze_source(src, path=path),
                       "exception-hygiene")) == flagged


def test_exception_hygiene_waivable_with_reason():
    src = ("def f():\n"
           "    try:\n"
           "        g()\n"
           "    except Exception:  " + ALLOW
           + "[exception-hygiene] fallback label is always correct\n"
           "        x = 1\n")
    (f,) = [x for x in analyze_source(src, path=DATA)
            if x.rule == "exception-hygiene"]
    assert f.suppressed and f.reason == "fallback label is always correct"


# ---------------------------------------------------------------------------
# the suppression ledger's own hygiene
# ---------------------------------------------------------------------------

def test_reasonless_suppression_is_rejected():
    src = ("def f(a: SpCSR):\n    return a.toarray()  " + ALLOW
           + "[no-densify]\n")
    rules = sorted(f.rule for f in active(analyze_source(src, path=HOT)))
    # the waiver is void AND the ledger defect itself is reported
    assert rules == ["no-densify", "suppression-hygiene"]


def test_unknown_rule_in_suppression_is_flagged():
    src = "x = 1  " + ALLOW + "[no-such-rule] stale waiver\n"
    (f,) = active(analyze_source(src, path=COLD))
    assert f.rule == "suppression-hygiene" and "no-such-rule" in f.message


def test_reference_only_rules_are_unknown_to_the_port():
    # jit-cache, donation-safety and pallas-purity have no eager meaning;
    # a waiver naming one is dead in the port
    for name in ("jit-cache", "donation-safety", "pallas-purity"):
        src = "x = 1  " + ALLOW + f"[{name}] reason\n"
        (f,) = active(analyze_source(src, path=COLD))
        assert f.rule == "suppression-hygiene" and name in f.message


# ---------------------------------------------------------------------------
# parity with the reference's analyzer
# ---------------------------------------------------------------------------

WAIVERS = (
    "def f():\n"
    "    try:\n"
    "        g()\n"
    "    except Exception:  " + ALLOW + "[exception-hygiene] a good reason\n"
    "        x = 1\n"
    "    try:\n"
    "        g()\n"
    "    except Exception:  " + ALLOW + "[exception-hygiene]\n"
    "        x = 2\n"
    "    y = 3  " + ALLOW + "[no-such-rule] a stale waiver\n"
)


def _records(findings):
    return sorted((f.rule, f.line, f.col, f.suppressed, f.reason)
                  for f in findings)


@pytest.mark.parametrize("fixture", ["bare_and_swallowed",
                                     "reported_and_narrow", "waivers"])
def test_same_records_as_the_reference(fixture):
    src = {"bare_and_swallowed": BARE_AND_SWALLOWED,
           "reported_and_narrow": REPORTED_AND_NARROW,
           "waivers": WAIVERS}[fixture]
    names = ["exception-hygiene"]
    ref = ref_analyze_source(src, path="src/repro/data/fixture.py",
                             rule_names=names)
    port = analyze_source(src, path=DATA, rule_names=names)
    assert _records(port) == _records(ref)
    assert [f.path for f in port] == [DATA] * len(port)
    if fixture == "waivers":
        # a good waiver, a reasonless one (void, and flagged) and an
        # unknown rule
        assert sorted(f.rule for f in active(port)) == [
            "exception-hygiene", "suppression-hygiene",
            "suppression-hygiene"]


def test_json_report_shape_and_summary_keys_match_the_reference():
    src = "def f(a: SpCSR):\n    return a.toarray()\n"
    findings = analyze_source(src, path=HOT)
    report = json.loads(render_json(findings))
    assert set(report) == {"findings", "errors", "summary"}
    assert report["summary"]["active"] == len(findings) >= 1
    assert not report["summary"]["ok"]
    rec = report["findings"][0]
    assert {"rule", "path", "line", "col", "message",
            "suppressed"} <= set(rec)
    ref = json.loads(ref_render_json(ref_analyze_source(
        src, path="src/repro/sparse/fixture.py")))
    assert set(ref["summary"]) == set(report["summary"])
    assert set(ref) == set(report)


def _files(root, pkg):
    bad = root / "src" / pkg / "data" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f():\n    try:\n        g()\n    except:\n"
                   "        pass\n")
    clean = root / "clean.py"
    clean.write_text("x = 1\n")
    broken = root / "broken.py"
    broken.write_text("def (\n")
    return {"clean": clean, "bad": bad, "broken": broken}


def test_cli_exit_codes_match_the_reference(tmp_path, capsys):
    ref, port = (_files(tmp_path / "ref", "repro"),
                 _files(tmp_path / "port", "repro_torch"))
    for kind, want in (("clean", 0), ("bad", 1), ("broken", 2)):
        assert ref_main([str(ref[kind])]) == want, kind
        assert port_main([str(port[kind])]) == want, kind
    capsys.readouterr()
    # and as a command, with the JSON report
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        str(port["bad"]), "--format", "json"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr[-2000:]
    assert json.loads(r.stdout)["summary"]["active"] == 1
    assert port_main([str(port["clean"]), "--rules", "no-such"]) == 2


def test_list_rules_is_the_references_less_three(capsys):
    port_main(["--list-rules"])
    port_out = capsys.readouterr().out
    ref_main(["--list-rules"])
    ref_out = capsys.readouterr().out

    def names(out):
        return {line.split(":")[0].split(" ")[0]
                for line in out.splitlines() if line.strip()}

    gone = {"jit-cache", "donation-safety", "pallas-purity"}
    assert names(port_out) == names(ref_out) - gone
    assert "pallas-tiles" in names(port_out)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_port_analyzes_clean():
    """Zero unsuppressed findings and zero parse errors over the port and
    its tests, and every suppression carries a reason."""
    findings, errors = analyze_paths(
        [str(REPO / "src" / "repro_torch")]
        + sorted(str(p) for p in (REPO / "tests").glob("test_torch_*.py")))
    assert errors == []
    assert active(findings) == []
    assert all(f.reason for f in findings if f.suppressed)
    assert len([f for f in findings if f.suppressed]) >= 3
