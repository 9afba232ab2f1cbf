"""The port's analyzer, IR half (``repro_torch.analysis.ir``) and its
runtime guards (``repro_torch.analysis.runtime``): every seeded
regression must flag (the CLI would exit 1), each through a custom
:class:`IRTarget` run on the ``meta`` device so that the defect is
isolated from the real engines — a densifying edit (an outer product of
4096 f32 values, flagged by the reference's ``run_ir`` too), an illegal
tile, a fused working set above the card's shared memory, a collective on
an axis the grid does not have, on a group of no axis, or from a target
with no grid, and tampering with the budget ledger; the ledgers of
waivers keep their hygiene; the constants and the target catalog are the
reference's; ``memory_guard`` on meta is the IR peak and
``recompile_guard`` counts ``nvcc`` builds; and the port's entry points
gate clean through the actual CLI (``--ir``) in a subprocess at the end.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.analysis.ir import IRTarget as RefIRTarget
from repro.analysis.ir import run_ir as ref_run_ir
from repro.analysis.ir.targets import UNSUPPORTED_PAIRS as REF_UNSUPPORTED
from repro.analysis.ir.targets import default_targets as ref_default_targets
from repro_torch.analysis import (
    MemoryReport, RecompilationError, memory_guard, recompile_guard,
)
from repro_torch.analysis.ir import (
    ALIASES, CANON, HEADROOM, UNSUPPORTED_PAIRS, IRTarget, TRACE_PASS,
    default_targets, load_waivers, peak_live_bytes, run_ir,
)
from repro_torch.analysis.ir.targets import (
    canon_operand, canon_u0, engine_fn, to_reference_name,
)
from repro_torch.kernels import _build
from repro_torch.kernels.autotune import SMEM_BUDGET, fused_working_set
from repro_torch.kernels.bsr import bsr_operand
from repro_torch.kernels.bsr_spmm import bsr_spmm, check_operands
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_nmf_mesh

REPO = Path(__file__).resolve().parents[1]


def meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def exit_code(result):
    """The CLI's 0/1/2 contract applied to an IRRunResult."""
    if result.errors:
        return 2
    return 1 if any(not f.suppressed for f in result.findings) else 0


def _run(targets, tmp_path, **kw):
    """run_ir against throwaway ledgers, so the repo's own are untouched."""
    return run_ir(targets=targets,
                  budgets_path=str(tmp_path / "budgets.json"),
                  waivers_path=str(tmp_path / "waivers.json"), **kw)


def active(result, rule=None):
    return [f for f in result.findings
            if not f.suppressed and (rule is None or f.rule == rule)]


# ---------------------------------------------------------------------------
# dense-blowup: a densifying edit is caught from what runs, not the source
# ---------------------------------------------------------------------------

def _densifying_target():
    def f(values):  # 16 KiB of "sparse values"...
        return torch.outer(values, values).sum()  # ...blown up to 64 MiB

    return IRTarget(name="fixture:densify", kind="engine", fn=f,
                    args=lambda: (meta(4096),), operand_bytes=4096 * 4)


def test_dense_blowup_flags_densifying_edit_in_both_analyzers(tmp_path):
    result = _run([_densifying_target()], tmp_path)
    (f,) = active(result, "dense-blowup")
    assert f.path == "ir://fixture:densify"
    assert "4096.0x" in f.message and "outer" not in f.message.split("`")[0]
    assert exit_code(result) == 1

    def g(values):
        return jnp.outer(values, values).sum()

    ref_target = RefIRTarget(
        name="fixture:densify", kind="engine",
        trace=lambda: jax.make_jaxpr(g)(jax.ShapeDtypeStruct(
            (4096,), jnp.float32)), operand_bytes=4096 * 4)
    ref = ref_run_ir(targets=[ref_target],
                     budgets_path=str(tmp_path / "ref_b.json"),
                     waivers_path=str(tmp_path / "ref_w.json"))
    assert [f.rule for f in ref.findings if not f.suppressed] == [
        "dense-blowup"]
    assert exit_code(ref) == 1


def test_dense_blowup_passes_well_behaved_code(tmp_path):
    t = IRTarget(name="fixture:clean", kind="engine",
                 fn=lambda v: (v * 2.0).sum(), args=lambda: (meta(4096),),
                 operand_bytes=4096 * 4)
    result = _run([t], tmp_path)
    assert exit_code(result) == 0, [f.message for f in active(result)]


# ---------------------------------------------------------------------------
# pallas-tiles: the wrappers' legality checks and the shared memory
# ---------------------------------------------------------------------------

def _tiles(bm):
    a = bsr_operand(canon_operand("torch-csr", "cpu").values.new_ones(
        (512, 384)).numpy(), bm=bm, bk=128).to("meta").bsr
    return a, meta(384, 4)


def test_pallas_tiles_flags_an_illegal_tile(tmp_path):
    a, u = _tiles(256)
    legal = (("bsr_spmm", lambda: check_operands(a, u)),)
    checked = IRTarget(name="fixture:bm256", kind="kernel",
                       fn=lambda: None, checks=legal)
    # the wrapper itself refuses the operand on meta as on the card
    launched = IRTarget(name="fixture:bm256-launch", kind="kernel",
                        fn=bsr_spmm, args=lambda: (a, u), checks=legal)
    result = _run([checked, launched], tmp_path)
    msgs = [f.message for f in active(result, "pallas-tiles")]
    assert msgs and all("bm=256" in m for m in msgs), msgs
    (trace,) = active(result, TRACE_PASS)
    assert trace.path == "ir://fixture:bm256-launch" and "bm=256" in \
        trace.message
    assert exit_code(result) == 1


def test_pallas_tiles_flags_a_working_set_above_shared_memory(tmp_path):
    big = fused_working_set(128, 128, 128)
    assert big > SMEM_BUDGET == 232_448
    t = IRTarget(name="fixture:fused-k128", kind="kernel", fn=lambda: None,
                 smem_bytes=lambda: big)
    result = _run([t], tmp_path)
    (f,) = active(result, "pallas-tiles")
    assert str(big) in f.message and "232448" in f.message
    fits = IRTarget(name="fixture:fused-k4", kind="kernel", fn=lambda: None,
                    smem_bytes=lambda: fused_working_set(128, 128, 4))
    assert exit_code(_run([fits], tmp_path)) == 0


def test_kernel_targets_are_legal_and_record_their_launch(tmp_path):
    kernels = [t for t in default_targets() if t.kind == "kernel"]
    assert [t.name for t in kernels] == [
        "kernel:bsr_spmm", "kernel:bsr_spmm_gram", "kernel:gram",
        "kernel:project_mask", "kernel:flash_attention"]
    result = _run(kernels, tmp_path, update_budgets=True)
    assert exit_code(result) == 0, [f.message for f in active(result)]
    for t in kernels:
        launches = t.traced().mode.costs.launches
        assert launches == {t.name.split(":")[1]: 1.0}, (t.name, launches)
    assert result.measured["kernel:bsr_spmm_gram"]["smem_bytes"] == \
        fused_working_set(128, 128, 4)


# ---------------------------------------------------------------------------
# collectives: the grid's axes and groups
# ---------------------------------------------------------------------------

def _grid_target(name, body, grid=True):
    mesh = make_nmf_mesh(2, 2, device="meta")
    return IRTarget(name=name, kind="mesh", fn=lambda x: body(mesh, x),
                    args=lambda: (meta(8, 8),), requires_devices=4,
                    grid=(lambda: mesh) if grid else None)


def test_collectives_off_the_grids_axes_are_flagged(tmp_path):
    with fake_world(4):
        stray = dist.new_group([0, 3])
        targets = [
            _grid_target("fixture:good-axis",
                         lambda m, x: m.all_reduce(x, "data")),
            _grid_target("fixture:bad-axis",
                         lambda m, x: m.all_reduce(x, "modle")),  # repro: allow[psum-axis] deliberate fixture: the axis that is not the grid's IS the test
            _grid_target("fixture:stray-group",
                         lambda m, x: dist.all_reduce(x.clone(),
                                                      group=stray)),
            _grid_target("fixture:no-grid",
                         lambda m, x: m.all_reduce(x, "model"), grid=False),
        ]
        result = _run(targets, tmp_path)
    by_target = {}
    for f in active(result):
        by_target.setdefault(f.path, []).append((f.rule, f.message))
    assert "ir://fixture:good-axis" not in by_target
    ((rule, msg),) = by_target["ir://fixture:bad-axis"]
    assert rule == TRACE_PASS and "'modle'" in msg
    ((rule, msg),) = by_target["ir://fixture:stray-group"]
    assert rule == "collectives" and "no axis group" in msg
    ((rule, msg),) = by_target["ir://fixture:no-grid"]
    assert rule == "collectives" and "no grid" in msg
    assert exit_code(result) == 1


def test_grid_targets_record_their_collectives(tmp_path):
    mesh_targets = [t for t in default_targets() if t.kind == "mesh"]
    with fake_world(4):
        result = _run(mesh_targets[:2], tmp_path, update_budgets=True)
    assert exit_code(result) == 0, [f.message for f in active(result)]
    for t in mesh_targets[:2]:
        got = result.measured[t.name]["collectives"]
        assert got["all_reduce"]["calls"] > 0 and \
            got["all_reduce"]["bytes"] > 0, (t.name, got)


# ---------------------------------------------------------------------------
# peak-memory: the meta planner and the committed budget ledger
# ---------------------------------------------------------------------------

def test_peak_live_bytes_on_a_known_call():
    report = peak_live_bytes(lambda x: x + 1.0, meta(8))
    # input (32 B) and output (32 B) both live at the add
    assert report.peak_bytes == 64 and report.input_bytes == 32
    # the add is this file's, not the port's: no port source line
    assert report.peak_op == "add" and report.peak_source is None


def test_peak_names_the_ports_source_line():
    a, u0 = canon_operand("cuda-bsr"), canon_u0()
    report = peak_live_bytes(engine_fn("als", "cuda-bsr"), a, u0)
    assert report.peak_source.startswith("repro_torch/")
    path, line = report.peak_source.rsplit(":", 1)
    assert (REPO / "src" / path).is_file() and int(line) > 0


def _budgeted_target(name="fixture:budgeted", width=4096):
    return IRTarget(name=name, kind="engine",
                    fn=lambda v: (v * 2.0 + 1.0).sum(),
                    args=lambda: (meta(width),), operand_bytes=width * 4,
                    budget_key=name)


def test_budget_lifecycle_baseline_gate_regress(tmp_path):
    missing = _run([_budgeted_target()], tmp_path)
    assert any("no committed peak-memory budget" in f.message
               for f in active(missing, "peak-memory"))
    assert exit_code(missing) == 1

    baseline = _run([_budgeted_target()], tmp_path, update_budgets=True)
    assert exit_code(baseline) == 0 and baseline.budgets_written
    ledger = json.loads((tmp_path / "budgets.json").read_text())
    assert "fixture:budgeted" in ledger["budgets"]
    assert ledger["config"]["headroom"] == HEADROOM

    assert exit_code(_run([_budgeted_target()], tmp_path)) == 0

    ledger["budgets"]["fixture:budgeted"]["peak_bytes"] = 1
    (tmp_path / "budgets.json").write_text(json.dumps(ledger))
    regressed = _run([_budgeted_target()], tmp_path)
    (f,) = active(regressed, "peak-memory")
    assert "peak-memory regression" in f.message
    assert exit_code(regressed) == 1


def test_stale_budget_entry_is_flagged(tmp_path):
    (tmp_path / "budgets.json").write_text(json.dumps(
        {"budgets": {"fixture:gone": {"peak_bytes": 123}}}))
    result = _run([_budgeted_target()], tmp_path, update_budgets=True)
    assert any("matches no traced target" in f.message
               for f in active(result, "peak-memory"))
    ledger = json.loads((tmp_path / "budgets.json").read_text())
    assert "fixture:gone" not in ledger["budgets"]


def test_device_skipped_target_keeps_its_budget(tmp_path):
    huge = _budgeted_target(name="fixture:needs-cluster")
    huge.requires_devices = 10_000
    (tmp_path / "budgets.json").write_text(json.dumps(
        {"budgets": {"fixture:needs-cluster": {"peak_bytes": 123}}}))
    result = _run([_budgeted_target(), huge], tmp_path, update_budgets=True)
    assert result.skipped_targets == [
        {"target": "fixture:needs-cluster",
         "reason": "needs 10000 ranks, have 1"}]
    assert exit_code(result) == 0
    ledger = json.loads((tmp_path / "budgets.json").read_text())
    assert ledger["budgets"]["fixture:needs-cluster"]["peak_bytes"] == 123


# ---------------------------------------------------------------------------
# waivers: the IR-side suppression ledger
# ---------------------------------------------------------------------------

def test_waiver_with_reason_suppresses(tmp_path):
    (tmp_path / "waivers.json").write_text(json.dumps({"waivers": [
        {"pass": "dense-blowup", "target": "fixture:*",
         "reason": "test fixture densifies on purpose"}]}))
    result = _run([_densifying_target()], tmp_path)
    assert exit_code(result) == 0
    (f,) = [f for f in result.findings if f.rule == "dense-blowup"]
    assert f.suppressed and f.reason == "test fixture densifies on purpose"


def test_reasonless_waiver_is_void_and_flagged(tmp_path):
    (tmp_path / "waivers.json").write_text(json.dumps({"waivers": [
        {"pass": "dense-blowup", "target": "fixture:*", "reason": "  "}]}))
    result = _run([_densifying_target()], tmp_path)
    assert sorted(f.rule for f in active(result)) == [
        "dense-blowup", "suppression-hygiene"]
    assert exit_code(result) == 1


@pytest.mark.parametrize("text", ["", "[1, 2]", '{"waivers": 3}'])
def test_malformed_waiver_ledger_is_a_finding_not_a_crash(tmp_path, text):
    (tmp_path / "waivers.json").write_text(text)
    waivers, hygiene = load_waivers(tmp_path / "waivers.json")
    assert waivers == []
    (f,) = hygiene
    assert "unreadable" in f.message


def test_unknown_pass_waiver_is_flagged(tmp_path):
    (tmp_path / "waivers.json").write_text(json.dumps({"waivers": [
        {"pass": "no-such-pass", "target": "*", "reason": "stale"}]}))
    waivers, hygiene = load_waivers(tmp_path / "waivers.json")
    assert waivers == []
    (f,) = hygiene
    assert "no-such-pass" in f.message


def test_waiver_ledgers_match_the_references_hygiene(tmp_path):
    from repro.analysis.ir import load_waivers as ref_load_waivers

    entries = [{"pass": "pallas-tiles", "target": "kernel:*",
                "reason": "kept"},
               {"pass": "dense-blowup", "target": "*", "reason": ""},
               {"pass": "no-such-pass", "target": "*", "reason": "stale"}]
    (tmp_path / "w.json").write_text(json.dumps({"waivers": entries}))
    port = load_waivers(tmp_path / "w.json")
    ref = ref_load_waivers(tmp_path / "w.json")
    assert port[0] == ref[0] == entries[:1]
    assert [(f.rule, f.line, f.message) for f in port[1]] == \
        [(f.rule, f.line, f.message) for f in ref[1]]


# ---------------------------------------------------------------------------
# the reference's constants and catalog
# ---------------------------------------------------------------------------

def test_canon_multiplier_and_headroom_are_the_references_ledger():
    with open(REPO / "analysis" / "ir_budgets.json") as fh:
        config = json.load(fh)["config"]
    assert dict(CANON, headroom=HEADROOM) == config


def test_targets_and_unsupported_pairs_are_the_references():
    names = [t.name for t in default_targets()]
    ours = {to_reference_name(n) for n in names
            if "cuda-bsr-unfused" not in n}
    assert ours == {t.name for t in ref_default_targets()}
    assert sorted(n for n in names if "cuda-bsr-unfused" in n) == [
        "als[cuda-bsr-unfused]", "enforced[cuda-bsr-unfused]",
        "streaming[cuda-bsr-unfused]"]
    assert {to_reference_name(k): v for k, v in UNSUPPORTED_PAIRS.items()
            }.keys() == REF_UNSUPPORTED.keys()
    assert set(ALIASES.values()) <= {n.split("[")[1].rstrip("]").split(",")[
        -1] for n in names if "[" in n}


# ---------------------------------------------------------------------------
# runtime guards
# ---------------------------------------------------------------------------

def test_memory_guard_on_meta_is_the_ir_peak():
    a, u0 = canon_operand("torch-csr"), canon_u0()
    report = memory_guard(engine_fn("als", "torch-csr"), a, u0)
    assert isinstance(report, MemoryReport) and report.supported
    assert report.device == "meta"
    with open(REPO / "analysis" / "torch_ir_budgets.json") as fh:
        budget = json.load(fh)["budgets"]["als[torch-csr]"]
    assert report.peak_bytes == budget["peak_bytes"]
    assert report.argument_bytes == budget["input_bytes"]
    assert report.output_bytes == budget["output_bytes"]
    with pytest.raises(Exception, match="scratch"):
        memory_guard(engine_fn("als", "torch-csr"), a, u0, max_temp_bytes=1)


def test_memory_guard_has_no_allocator_to_read_on_the_cpu():
    x = torch.ones(8)
    with pytest.raises(RuntimeError, match="no allocator"):
        memory_guard(lambda t: t + 1, x)
    report = memory_guard(lambda t: t + 1, x, allow_unsupported=True)
    assert not report.supported and "cpu" in report.reason


class _FakeBuild:
    """What ``subprocess.Popen`` would return for a started build."""


def test_recompile_guard_counts_nvcc_builds(monkeypatch):
    started = []

    def fake_start(source):
        started.append(source)
        return None if "built" in str(source) else _FakeBuild()

    monkeypatch.setattr(_build, "_start_build", fake_start)
    # positive control: a build started inside the block is counted
    with recompile_guard(max_compiles=5) as counter:
        _build._start_build(Path("gram.cu"))
    assert counter.count == 1 and counter.events == ["gram.cu"]
    with pytest.raises(RecompilationError, match="gram.cu"):
        with recompile_guard():
            _build._start_build(Path("gram.cu"))
    # an already-built library is free
    with recompile_guard() as counter:
        _build._start_build(Path("built.cu"))
    assert counter.count == 0
    # the guard restores what it wrapped
    assert _build._start_build is fake_start


def test_second_identical_cpu_fit_builds_nothing():
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    a = canon_operand("torch-csr", "cpu")
    cfg = NMFConfig(k=3, iters=3, backend="cuda-bsr",
                    sparsity=Sparsity(t_u=300, t_v=200))
    EnforcedNMF(cfg, device="cpu").fit(a)
    with recompile_guard() as counter:
        EnforcedNMF(cfg, device="cpu").fit(a)
    assert counter.count == 0


# ---------------------------------------------------------------------------
# the gate: the actual CLI over the port's entry points
# ---------------------------------------------------------------------------

def test_port_ir_gate_is_clean():
    """``python -m repro_torch.analysis src/repro_torch --ir`` exits 0 with
    the committed ledgers: every (solver, backend) pair, both grids and the
    five kernels run, budgeted and in contract, none skipped."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--ir", "--format", "json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    report = json.loads(out.stdout)
    assert report["summary"]["ok"]
    assert report["ir"]["skipped_targets"] == []
    measured = report["ir"]["measured"]
    assert set(measured) == {t.name for t in default_targets()}
    with open(REPO / "analysis" / "torch_ir_budgets.json") as fh:
        ledger = json.load(fh)
    # the ledger on disk covers exactly what this run measured; exit 0
    # already held every peak within the ledger's headroom
    assert set(ledger["budgets"]) == set(measured)
