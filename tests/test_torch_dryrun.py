"""The dry-run on the meta device (``launch/dryrun.py``,
``launch/cost_analysis.py``, ``configs.cell_supported``,
``launch/mesh.py::make_production_mesh``, ``launch/nmf_run.py``'s
``nmf_input_specs`` / ``nmf_dryrun_cell``, the kernels' meta branches and
the ``scan`` helper) held against the reference's dry-run
(``repro.launch.dryrun``, ``repro.launch.hlo_analysis``).

Bars, each stated where it is checked:

* ``cell_supported`` equal to the reference's for all 40 cells, 8 skipped;
* a rank's ``argument_bytes`` exactly the reference's per-device bytes for
  every (arch x shape) on 4x2, 2x2x2, 16x16 and 2x16x16, the reference's
  reckoned from its own ``param_pspecs`` / ``batch_pspecs`` /
  ``cache_pspecs`` on ``jax.eval_shape`` shapes (each dim divided by the
  product of its axes' sizes: no device needed);
* in one subprocess on 8 XLA host devices, the reference's compiled
  ``argument_size_in_bytes`` exactly, and its ``hlo_analysis`` dot FLOPs
  within 2% (a data-only 8x1 grid, and codeqwen1.5-7b's smoke config on
  4x2), the dots its per-device module does not do whole counted apart
  and named (``test_cell_matches_reference_compiled_dryrun``), and the
  NMF cell's per-rank bytes exactly at a small size on a 2x2 grid;
* loops: 8 chained 128 x 128 products count exactly 8 * 2 * 128^3, and a
  scaled ``scan`` counts exactly the FLOPs the fully run loop counts for
  the sLSTM and the SSD (forward and backward), and its bytes (exactly
  forward, within 1e-4 with backward);
* ``train_4k`` of all ten architectures ``ok`` on 16x16 and 2x16x16 at
  full width and a few layers of each kind (:func:`_cut`): a rank's
  argument bytes the reference's, its state bytes three times its
  parameter blocks', and for the moe, hybrid, ssm and encdec cells the
  launcher's init peak under the step's peak;
* each kernel's meta branch: one launch, the kernel's own cost and bound
  exactly ``PERF.md``'s cost and bound columns at the table's shapes
  (``KERNEL_TABLE``), never its plain version, and no launch counted on
  the card's counter.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_supported as ref_cell_supported
from repro.launch import nmf_run as ref_nmf_run
from repro.models import api as ref_api
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, cell_supported
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build, ref
from repro_torch.kernels import bsr_spmm as spmm_mod
from repro_torch.kernels.bsr import BSR, SplitPlan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused import bsr_spmm_gram
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import project_mask, relu_topk
from repro_torch.launch import dryrun, nmf_run
from repro_torch.launch.cost_analysis import CostMode, bound_ms
from repro_torch.launch.mesh import (
    make_nmf_mesh, make_production_mesh, spawn_mesh,
)
from repro_torch.models import mamba, xlstm
from repro_torch.scan import scan, tensors

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")

MESHES = {"4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

#: the subprocess's cells: a small train shape the reference compiles in
#: seconds on host devices
SMALL_TRAIN = ("train_small", 256, 32, "train")


# ---------------------------------------------------------------------------
# cell_supported
# ---------------------------------------------------------------------------

def test_cell_supported_matches_reference_for_all_40_cells():
    n_cells = n_skip = 0
    for name, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            got = cell_supported(cfg, shape)
            assert got == ref_cell_supported(REF_ARCHS[name],
                                             REF_SHAPES[sname])
            n_cells += 1
            n_skip += not got[0]
    assert (n_cells, n_skip) == (40, 8)


# ---------------------------------------------------------------------------
# argument_bytes against the reference's specs
# ---------------------------------------------------------------------------

def _ref_spec_bytes(sd, spec, sizes) -> int:
    n = 1
    for i, d in enumerate(sd.shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            div = 1
        else:
            div = math.prod(sizes.get(a, 1)
                            for a in ((ax,) if isinstance(ax, str) else ax))
        assert d % div == 0
        n *= d // div
    return n * jnp.dtype(sd.dtype).itemsize


def _ref_tree_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_ref_spec_bytes(sd, sp, sizes)
               for sd, sp in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, cut=False):
    cfg = _cut(REF_ARCHS[arch]) if cut else REF_ARCHS[arch]
    return jax.eval_shape(
        lambda: ref_api.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))


def _cut(cfg):
    """``cfg`` (either package's) at full width with its depth cut to a
    few layers of every kind it has: two layers (an xlstm's second its
    sLSTM; an encdec's two of each stack), a hybrid's one group and a
    tail of one."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every + 1)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=2, slstm_at=(1,))
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=2, n_enc_layers=2)
    return dataclasses.replace(cfg, n_layers=2)


def _ref_argument_bytes(arch, shape_name, sizes, cut=False) -> int:
    """The reference dry-run's per-device argument bytes
    (``repro.launch.dryrun.lower_cell``'s in_shardings), from its specs;
    ``cut``: at :func:`_cut`'s depth."""
    cfg, shape = REF_ARCHS[arch], REF_SHAPES[shape_name]
    if cut:
        cfg = _cut(cfg)
    mesh = types.SimpleNamespace(shape=dict(sizes))
    params = _ref_params(arch, cut)
    pspecs = ref_api.param_pspecs(cfg, params, dryrun.RULES, mesh=mesh)
    pb = _ref_tree_bytes(params, pspecs, sizes)
    if shape.kind != "decode":
        batch = ref_api.input_specs(cfg, shape)
        bb = _ref_tree_bytes(batch, ref_api.batch_pspecs(cfg, shape, mesh),
                             sizes)
        # AdamW: mu and nu (f32, the parameters' specs) and an int32 count
        return pb + (2 * pb + 4 if shape.kind == "train" else 0) + bb
    cache = ref_api.init_decode_cache(cfg, shape, as_specs=True)
    cb = _ref_tree_bytes(cache, ref_api.cache_pspecs(cfg, shape, mesh, cache),
                         sizes)
    dp = ref_api.batch_axes_for(shape.global_batch, mesh, ("pod", "data"))
    tok = ref_api.input_specs(cfg, shape)["token"]
    return pb + cb + _ref_spec_bytes(tok, P(dp if dp else None), sizes) + 4


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_argument_bytes_equal_reference_per_device_bytes(arch, mesh_name):
    """Exact, for every shape of the arch the reference defines."""
    sizes = MESHES[mesh_name]
    cfg = ARCHS[arch]
    for sname, shape in SHAPES.items():
        if not cell_supported(cfg, shape)[0]:
            continue
        got = dryrun.argument_bytes(cfg, shape, sizes)
        assert got == _ref_argument_bytes(arch, sname, sizes), (sname, got)


# ---------------------------------------------------------------------------
# against the reference's compiled dry-run, on 8 XLA host devices
# ---------------------------------------------------------------------------

_REF_CELLS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import collections, json, re, sys, tempfile
    import jax, numpy as np
    from repro.configs import ARCHS, ShapeSpec, smoke_config
    from repro.launch import hlo_analysis as H
    from repro.launch.dryrun import run_cell
    from repro.launch.nmf_run import nmf_dryrun_cell

    GROUP = re.compile(r"replica_groups=\\[(\\d+),(\\d+)\\]")

    def dots_apart(text):
        # the dots of the per-device module that are not the whole
        # step's: (a) a partial-sum dot (its result, through at most one
        # elementwise fusion, is all-reduced over a group of g devices)
        # computes 1/g of its dot: the rest, (g - 1) times it, is done on
        # the other devices; (b) the one-hot label dot of the loss
        # ("bcv,bcv->bc"), which the port takes with a gather
        comps, entry = H.parse_hlo(text)
        type_of = {op.name: op.result_type for c in comps.values()
                   for op in c.ops}
        mult = collections.Counter()

        def walk(name, m):
            mult[name] += m
            for op in comps[name].ops:
                called = H._CALLED_RE.search(op.line)
                if op.opcode == "while":
                    cond = H._COND_RE.search(op.line).group(1)
                    walk(called.group(1), m * H._trip_count(comps[cond]))
                elif op.opcode in ("call", "fusion") and called:
                    walk(called.group(1), m)

        walk(entry, 1)
        partial = label = 0.0
        for name, m in mult.items():
            users = collections.defaultdict(list)
            for op in comps[name].ops:
                args = op.line.split(f" {op.opcode}(", 1)[-1].split(")")[0]
                for a in re.findall(r"%([\\w.\\-~]+)", args):
                    users[a].append(op)
            for op in comps[name].ops:
                if op.opcode != "dot":
                    continue
                f = m * H._dot_flops(op.line, op.result_type, type_of)
                if "bcv,bcv->bc" in op.line:
                    label += f
                near = users[op.name] + [v for u in users[op.name]
                                         if u.opcode == "fusion"
                                         for v in users[u.name]]
                for u in near:
                    if u.opcode == "all-reduce":
                        partial += (int(GROUP.search(u.line).group(2))
                                    - 1) * f
                        break
        return partial, label

    shape = ShapeSpec(*json.loads(sys.argv[1]))
    out = {}
    for arch, grid in (("llama3.2-1b", (8, 1)), ("codeqwen1.5-7b", (4, 2))):
        mesh = jax.make_mesh(grid, ("data", "model"))
        path = os.path.join(tempfile.mkdtemp(), "cell.hlo")
        rec = run_cell(smoke_config(ARCHS[arch]), shape, mesh,
                       verbose=False, save_hlo=path)
        assert rec["status"] == "ok", rec
        text = open(path).read()
        partial, label = dots_apart(text)
        out[arch] = dict(argument_bytes=rec["argument_bytes"],
                         flops=H.analyze(text).flops, partial_sum=partial,
                         label_dot=label)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    rec, _, _ = nmf_dryrun_cell(mesh, n=4096, m=1024, k=8, nnz_per_row=16,
                                iters=2)
    out["nmf"] = dict(argument_bytes=rec["argument_bytes"])
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_cells():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_CELLS,
                          json.dumps(SMALL_TRAIN)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


#: dot FLOPs of the port's whole step against the reference's, with the
#: dots the reference's per-device module does not do whole counted apart
FLOP_BAR = 0.02


@pytest.mark.parametrize("arch,grid", [("llama3.2-1b", (8, 1)),
                                       ("codeqwen1.5-7b", (4, 2))])
def test_cell_matches_reference_compiled_dryrun(ref_cells, arch, grid):
    """Argument bytes exactly the reference's compiled
    ``argument_size_in_bytes``.

    FLOPs within ``FLOP_BAR`` of the reference's ``hlo_analysis`` FLOPs,
    two structural gaps counted apart.  The reference's per-device module
    computes each microbatch whole on every device (its dots are
    [B S / M, .]: GSPMD does not split a microbatch's rows over "data"),
    so its FLOPs are the whole step's but for (a) its partial-sum dots: a
    dot whose weight is cut on its contracting dim (FSDP over "data", the
    MLP's hidden dim over "model") computes 1/g of itself and all-reduces
    over the g devices, so (g - 1) times it is added to the reference's
    side; (b) its one-hot label dot, which the port does with a gather
    (no dot), taken off the reference's side.  The port's rank computes
    its block: its FLOPs times the ranks are its whole step's, exactly."""
    from repro_torch.convert import _model
    from repro_torch.models import api
    from repro_torch.training.optimizer import AdamW

    cfg = smoke_config(ARCHS[arch])
    shape = ShapeSpec(*SMALL_TRAIN)
    with dryrun.fake_world(grid[0] * grid[1]):
        mesh = make_nmf_mesh(*grid, device="meta")
        rec = dryrun.lower_cell(cfg, shape, mesh)
    want = ref_cells[arch]
    assert rec["argument_bytes"] == want["argument_bytes"]
    model, opt = _model(cfg, "meta"), AdamW()
    state = opt.init(model)
    with CostMode() as mode:
        api.make_train_step(cfg, opt, microbatches=dryrun.MICROBATCHES)(
            model, state, dryrun._meta_batch(cfg, shape))
    whole = mode.costs.flops
    assert rec["flops"] * grid[0] * grid[1] == whole
    assert want["partial_sum"] > 0 and want["label_dot"] > 0
    ref_whole = want["flops"] + want["partial_sum"] - want["label_dot"]
    assert whole == pytest.approx(ref_whole, rel=FLOP_BAR)


def test_nmf_cell_bytes_match_reference(ref_cells):
    with dryrun.fake_world(4):
        rec = nmf_run.nmf_dryrun_cell(make_nmf_mesh(2, 2, device="meta"),
                                      n=4096, m=1024, k=8, nnz_per_row=16,
                                      iters=2)
    assert rec["status"] == "ok"
    assert rec["argument_bytes"] == ref_cells["nmf"]["argument_bytes"]


def test_nmf_input_specs_equal_reference():
    args = (4096, 1024, 8, 32, 64, 4, 2)
    got = nmf_run.nmf_input_specs(*args)
    want = ref_nmf_run.nmf_input_specs(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


# ---------------------------------------------------------------------------
# the grid, the command line
# ---------------------------------------------------------------------------

def test_production_mesh_only_on_the_fake_world(tmp_path):
    with pytest.raises(RuntimeError, match="fake process group"):
        make_production_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="fake process group"):
            make_production_mesh()
    finally:
        dist.destroy_process_group()
    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert (mesh.shape, mesh.device.type) == ((2, 16, 16), "meta")
    with dryrun.fake_world(256):
        assert make_production_mesh().shape == (16, 16)
    assert not dist.is_initialized()


def test_collectives_on_the_fake_grid_are_counted():
    """A meta tensor is reduced and exchanged in place, not staged through
    the host, and counted in calls and bytes."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        with CostMode() as mode:
            x = torch.empty((1000, 8), device="meta")
            y = mesh.all_reduce(x, "data")
            z = mesh.all_to_all(torch.empty((32, 4), device="meta"), "model")
    assert y.device.type == z.device.type == "meta"
    c = mode.costs
    assert c.coll_calls == {"all_reduce": 1, "all_to_all": 1}
    assert c.coll_by_kind == {"all_reduce": 32000, "all_to_all": 512}


@pytest.mark.parametrize("args", [["--arch", "llama3.2-1b", "--shape",
                                   "train_4k"], ["--nmf"]])
def test_command_line(args, tmp_path):
    out_file = tmp_path / "rec.jsonl"
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *args, "--out", str(out_file)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out_file.read_text().splitlines()[-1])
    assert rec["status"] == "ok"
    assert rec["argument_bytes"] > 0 and rec["bytes_per_device"] > 0
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--nmf", "--device", "cuda"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "meta device only" in bad.stderr


@pytest.mark.parametrize("arch,shape", [("xlstm-125m", "long_500k"),
                                        ("olmoe-1b-7b", "decode_32k"),
                                        ("seamless-m4t-large-v2",
                                         "prefill_32k"),
                                        ("llama3.2-1b", "long_500k")])
def test_cells_without_a_sharded_step(arch, shape):
    """The serving cells that had no sharded step before
    ``serving/sharding.py`` are ``ok`` (or the reference's skip; never
    ``error``): a rank's argument bytes the reference's, finite FLOPs, a
    rank's peak under the card's 80 GB."""
    with dryrun.fake_world(256):
        rec = dryrun.run_cell(ARCHS[arch], SHAPES[shape],
                              make_production_mesh(), verbose=False)
    if not cell_supported(ARCHS[arch], SHAPES[shape])[0]:
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec
    assert math.isfinite(rec["flops"]) and rec["flops"] > 0
    assert 0 < rec["bytes_per_device"] < 80e9
    assert rec["temp_bytes"] >= 0
    assert rec["argument_bytes"] == _ref_argument_bytes(
        arch, shape, MESHES["16x16"])


#: serving cells of the smoke configs on a 2x2 grid: (arch, seq, batch,
#: kind)
SERVING_CELLS = [("seamless-m4t-large-v2", 32, 4, "decode"),
                 ("olmoe-1b-7b", 16, 4, "prefill"),
                 ("zamba2-7b", 16, 4, "decode"),
                 ("xlstm-125m", 16, 4, "decode")]


@pytest.fixture(scope="module")
def serving_ranks():
    """:data:`SERVING_CELLS` run on four gloo ranks of the CPU."""
    out = spawn_mesh(ranks.serving_counts, 2, 2, backend="gloo",
                     device="cpu", args=(SERVING_CELLS,), timeout=300.0,
                     threads=1)
    return out[0]


@pytest.mark.parametrize("arch,seq,b,kind", SERVING_CELLS)
def test_serving_cell_counts_equal_the_ranks(serving_ranks, arch, seq, b,
                                             kind):
    """A serving cell's meta counts on a fake 2x2 (``lower_cell``) are rank
    0's on four gloo ranks running the same sharded step: the collectives'
    calls and bytes, the flash kernel's launches (its wrapper's calls
    there), the state's bytes."""
    cfg = smoke_config(ARCHS[arch])
    shape = ShapeSpec("cell", seq, b, kind)
    with dryrun.fake_world(4):
        rec = dryrun.lower_cell(cfg, shape, make_nmf_mesh(2, 2,
                                                          device="meta"))
    got = serving_ranks[(arch, kind)]
    assert rec["collectives"]["all_reduce"]["calls"] == \
        got["counts"]["all_reduce"]
    assert rec["collectives"]["all_reduce"]["bytes"] == \
        got["counts"]["bytes"]
    assert rec["launches"].get("flash_attention", 0) == \
        got["launches"]["flash_attention"]
    assert rec.get("state_bytes", 0) == got["state"]


# ---------------------------------------------------------------------------
# loops
# ---------------------------------------------------------------------------

def test_loop_of_8_products_counts_exactly():
    """The analogue of ``test_hlo_analysis_scales_loops``."""
    def body(c, _):
        return c @ c, None

    for scale in (True, False):
        with CostMode(scale_loops=scale) as mode:
            scan(body, torch.empty((128, 128), device="meta"), range(8))
        assert mode.costs.flops == 8 * 2 * 128 ** 3


def _slstm(cfg, s, grad):
    p = {name: torch.empty(shp, device="meta", requires_grad=grad)
         for name, shp in xlstm.slstm_shapes(cfg).items()}
    x = torch.empty((2, s, cfg.d_model), device="meta", requires_grad=grad)
    return lambda: xlstm.slstm_seq(p, x, cfg)[0]


def _ssd(cfg, s, grad):
    def t(*shape):
        return torch.empty(shape, device="meta", requires_grad=grad)

    x, dt, a_log = t(2, s, 4, 16), t(2, s, 4), t(4)
    b, c = t(2, s, 16), t(2, s, 16)
    return lambda: mamba.ssd_chunked(x, dt, a_log, b, c, chunk=16)


@pytest.mark.parametrize("loop", ["slstm", "ssd"])
def test_scaled_scan_counts_what_the_full_loop_counts(loop):
    """FLOPs exactly the full loop's, forward (the serving path) and
    forward + backward; bytes exactly forward, and within 1e-4 of them
    with backward, a named gap: autograd adds the steps' gradients of a
    leaf they share into one buffer, each add under the node that finishes
    last, so a scaled loop counts a few of those adds at another scale."""
    cfg = smoke_config(ARCHS["xlstm-125m"])
    for grad in (False, True):
        got = {}
        for scale in (True, False):
            fn = (_slstm if loop == "slstm" else _ssd)(cfg, 64, grad)
            with CostMode(scale_loops=scale) as mode:
                y = fn()
                if grad:
                    y.sum().backward()
            got[scale] = mode.costs
        assert got[True].flops > 0
        assert got[True].flops == got[False].flops
        if grad:
            assert got[True].hbm_bytes == pytest.approx(got[False].hbm_bytes,
                                                        rel=1e-4)
        else:
            assert got[True].hbm_bytes == got[False].hbm_bytes


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def _plain(*args, **kwargs):
    raise AssertionError("a meta branch ran its kernel's plain version")


@pytest.fixture
def no_plain(monkeypatch):
    for name in ("bsr_spmm_ref", "bsr_spmm_gram_ref", "gram_ref",
                 "project_mask_ref", "relu_topk_ref", "flash_attention_ref",
                 "unreferenced_rows"):
        monkeypatch.setattr(ref, name, _plain)
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_bsr(n, m, nrb, bcap, bm, bk, dtype=torch.float32, *, occupied):
    return BSR(_meta(nrb, bcap, bm, bk, dtype=dtype),
               _meta(nrb, bcap, dtype=torch.int32), (n, m),
               _meta(nrb, bcap, dtype=torch.int32), None,
               SplitPlan(_meta(133, dtype=torch.int32),
                         _meta(nrb, 2, dtype=torch.int32)), occupied)


#: PubMed's operand in each orientation, (n, m, nrb, bcap) at 128 x 128
#: tiles: 9,322 slots each way, of which the ingest of ``chip_smoke.py``'s
#: PubMed-shaped corpus finds 9,241 occupied (its phase 26 holds the meta
#: operand's count to the card's)
PUBMED_BSR = {"A @ V": (20112, 7510, 158, 59), "A^T @ U": (7510, 20112, 59,
                                                           158)}
PUBMED_OCCUPIED = 9241
#: the Wikipedia-shaped operand (``NMF_CONFIGS["wikipedia"]``, 143,462 x
#: 12,439) at 128 x 128 tiles: 109,858 slots of A and 72,324 of A^T hold
#: the same 67,455 occupied tiles (the head term reaches every column
#: block, so A^T's row-blocks run to bcap 738)
WIKI_BSR = {"A @ V": (143462, 12439, 1121, 98),
            "A^T @ U": (12439, 143462, 98, 738)}
WIKI_OCCUPIED = 67455
BF16 = torch.bfloat16


def _flash_case(b, h, hkv, sq, t, hd, causal):
    return lambda: flash_attention(
        _meta(b, h, sq, hd, dtype=BF16), _meta(b, hkv, t, hd, dtype=BF16),
        _meta(b, hkv, t, hd, dtype=BF16), causal=causal, groups=h // hkv)


def _bsr_case(orient, k, fn, dtype=torch.float32, wiki=False):
    n, m, nrb, bcap = (WIKI_BSR if wiki else PUBMED_BSR)[orient]
    return lambda: fn(_meta_bsr(n, m, nrb, bcap, 128, 128, dtype,
                                occupied=WIKI_OCCUPIED if wiki
                                else PUBMED_OCCUPIED),
                      _meta(m, k, dtype=dtype))


#: ``PERF.md``'s kernel table, each shape's launch as the cost model
#: counts it: (row, call, dtype, FLOPs, bytes, bound ms, bound by); the
#: bound is the larger of the bytes at 3.35 TB/s and the FLOPs at 67
#: TFLOP/s f32 or 989 TFLOP/s bf16 (one H100 SXM's published figures)
KERNEL_TABLE = {
    "relu_topk U f32": (1, lambda: relu_topk(_meta(20112, 5), 2011),
                        torch.float32, 4223520, 804484,
                        0.00024014447761194028, "bytes"),
    "relu_topk V f32": (1, lambda: relu_topk(_meta(7510, 5), 751),
                        torch.float32, 1577100, 300404,
                        8.967283582089552e-05, "bytes"),
    "relu_topk U bf16": (1, lambda: relu_topk(_meta(20112, 5, dtype=BF16),
                                              2011),
                         BF16, 4223520, 402242, 0.00012007223880597014,
                         "bytes"),
    "relu_topk V bf16": (1, lambda: relu_topk(_meta(7510, 5, dtype=BF16),
                                              751),
                         BF16, 1577100, 150202, 4.483641791044776e-05,
                         "bytes"),
    "relu_topk Wikipedia U": (1, lambda: relu_topk(_meta(143462, 5), 14346),
                              torch.float32, 30127020, 5738484,
                              0.0017129802985074627, "bytes"),
    "relu_topk Wikipedia V": (1, lambda: relu_topk(_meta(12439, 5), 1243),
                              torch.float32, 2612190, 497564,
                              0.0001485265671641791, "bytes"),
    "gram U k5": (2, lambda: gram(_meta(20112, 5)), torch.float32, 603360,
                  402340, 0.00012010149253731343, "bytes"),
    "gram V k5": (2, lambda: gram(_meta(7510, 5)), torch.float32, 225300,
                  150300, 4.4865671641791044e-05, "bytes"),
    "gram Wikipedia U k5": (2, lambda: gram(_meta(143462, 5)),
                            torch.float32, 4303860, 2869340,
                            0.0008565194029850746, "bytes"),
    "gram k256": (2, lambda: gram(_meta(20112, 256)), torch.float32,
                  1323208704, 20856832, 0.019749383641791046, "operations"),
    "gram U k5 bf16": (2, lambda: gram(_meta(20112, 5, dtype=BF16)), BF16,
                       603360, 201220, 6.006567164179104e-05, "bytes"),
    "gram k256 bf16": (2, lambda: gram(_meta(20112, 256, dtype=BF16)), BF16,
                       1323208704, 10559488, 0.0031520859701492537,
                       "bytes"),
    "bsr_spmm A @ V": (3, _bsr_case("A @ V", 5, spmm_mod.bsr_spmm),
                       torch.float32, 1514045440, 606207904,
                       0.18095758328358208, "bytes"),
    "bsr_spmm A^T @ U": (3, _bsr_case("A^T @ U", 5, spmm_mod.bsr_spmm),
                         torch.float32, 1514045440, 606207904,
                         0.18095758328358208, "bytes"),
    "bsr_spmm A @ V k256": (3, _bsr_case("A @ V", 256, spmm_mod.bsr_spmm),
                            torch.float32, 77519126528, 633940392,
                            1.1570018884776119, "operations"),
    "bsr_spmm A @ V bf16": (3, _bsr_case("A @ V", 5, spmm_mod.bsr_spmm,
                                         BF16),
                            BF16, 1514045440, 303122596,
                            0.09048435701492538, "bytes"),
    "bsr_spmm Wikipedia A @ V": (3, _bsr_case("A @ V", 5, spmm_mod.bsr_spmm,
                                              wiki=True),
                                 torch.float32, 11051827200, 4424288332,
                                 1.3206830841791044, "bytes"),
    "bsr_spmm Wikipedia A^T @ U": (3, _bsr_case("A^T @ U", 5,
                                                spmm_mod.bsr_spmm, wiki=True),
                                   torch.float32, 11051827200, 4424138196,
                                   1.3206382674626866, "bytes"),
    "bsr_spmm_gram A @ V": (4, _bsr_case("A @ V", 5, bsr_spmm_gram),
                            torch.float32, 1514270740, 606208004,
                            0.18095761313432837, "bytes"),
    "bsr_spmm_gram A^T @ U": (4, _bsr_case("A^T @ U", 5, bsr_spmm_gram),
                              torch.float32, 1514648800, 606208004,
                              0.18095761313432837, "bytes"),
    "bsr_spmm_gram A @ V bf16": (4, _bsr_case("A @ V", 5, bsr_spmm_gram,
                                              BF16),
                                 BF16, 1514270740, 303122696,
                                 0.09048438686567165, "bytes"),
    "bsr_spmm_gram Wikipedia A @ V": (4, _bsr_case("A @ V", 5, bsr_spmm_gram,
                                                   wiki=True),
                                      torch.float32, 11052200370, 4424288432,
                                      1.3206831140298507, "bytes"),
    "bsr_spmm_gram Wikipedia A^T @ U": (4, _bsr_case("A^T @ U", 5,
                                                     bsr_spmm_gram, wiki=True),
                                        torch.float32, 11056131060,
                                        4424138296, 1.3206382973134327,
                                        "bytes"),
    "flash llama3.2-1b": (5, _flash_case(4, 32, 8, 4096, 4096, 64, True),
                          BF16, 274945015808, 167772160,
                          0.27800304935085945, "operations"),
    "flash olmoe-1b-7b": (5, _flash_case(4, 16, 16, 4096, 4096, 128, True),
                          BF16, 274945015808, 268435456,
                          0.27800304935085945, "operations"),
    "flash zamba2-7b hd112": (5, _flash_case(4, 32, 32, 4096, 4096, 112,
                                             True),
                              BF16, 481153777664, 469762048,
                              0.48650533636400406, "operations"),
    "flash seamless encoder": (5, _flash_case(4, 16, 16, 4096, 4096, 64,
                                              False),
                               BF16, 274877906944, 134217728,
                               0.2779351940788676, "operations"),
    "flash one row T4096": (5, _flash_case(8, 16, 16, 1, 4096, 64, False),
                            BF16, 134217728, 134250496,
                            0.04007477492537313, "bytes"),
    "flash one row T32768": (5, _flash_case(8, 16, 16, 1, 32768, 64, False),
                             BF16, 1073741824, 1073774592,
                             0.32052972895522386, "bytes"),
}


@pytest.mark.parametrize("case", list(KERNEL_TABLE))
def test_meta_branch_counts_the_kernel_table(no_plain, case):
    """One launch, the kernel's own FLOPs and bytes and the bound they
    give, exactly ``PERF.md``'s table (the source of its cost column and
    of its bound column); the plain version never runs and the card's
    launch counts stay 0 (``no_plain``)."""
    _, call, dtype, flops, nbytes, ms, by = KERNEL_TABLE[case]
    with CostMode() as mode:
        out = call()
    assert {t.device.type for t in tensors(out)} == {"meta"}
    c = mode.costs
    (name,) = c.launches
    assert c.launches[name] == 1
    assert (c.kernel_flops[name], c.kernel_bytes[name]) == (flops, nbytes)
    assert bound_ms(flops, nbytes, dtype) == (pytest.approx(ms, rel=1e-12),
                                              by)


def test_epilogue_meta_branches_count_their_bounds(no_plain):
    """relu_topk at PubMed's U and V (k = 5): 4 (2 n + 1) bytes, the mean
    bound 0.000164909 ms (``PERF.md`` row 1); no host read (``_sync``);
    ``project_mask`` with tau given."""
    with CostMode() as mode:
        bounds = []
        for n in (20112, 7510):
            out, tau = relu_topk(_meta(n, 5), 2011)
            assert out.shape == (n, 5) and tau.shape == ()
            bounds.append(bound_ms(mode.costs.kernel_flops["relu_topk"],
                                   mode.costs.kernel_bytes["relu_topk"]))
            mode.costs.kernel_flops.clear()
            mode.costs.kernel_bytes.clear()
        project_mask(_meta(7510, 5), _meta())
    assert mode.costs.launches == {"relu_topk": 2, "project_mask": 1}
    assert all(by == "bytes" for _, by in bounds)
    assert sum(ms for ms, _ in bounds) / 2 == pytest.approx(
        0.00016490865671641791, rel=1e-12)


def test_bsr_meta_branches_count_the_occupied_tiles(no_plain):
    """The BSR products count the operand's occupied tiles: its cost
    follows the count, not the ``nrb x bcap`` slots, which only its
    block columns' bytes read; the outputs have the kernel's shapes."""
    u = _meta(7510, 5)
    for tiles in (PUBMED_OCCUPIED, 158 * 59):
        a = _meta_bsr(20112, 7510, 158, 59, 128, 128, occupied=tiles)
        with CostMode() as mode:
            y = spmm_mod.bsr_spmm(a, u)
            y2, g = bsr_spmm_gram(a, u)
        assert y.shape == y2.shape == (20112, 5) and g.shape == (5, 5)
        c = mode.costs
        assert c.launches == {"bsr_spmm": 1, "bsr_spmm_gram": 1}
        assert c.kernel_flops["bsr_spmm"] == 2 * tiles * 128 * 128 * 5
        assert c.kernel_bytes["bsr_spmm"] == 4 * (
            tiles * 128 * 128 + 158 * 59 + 7510 * 5 + 20112 * 5)
        assert c.kernel_bytes["bsr_spmm_gram"] == (
            c.kernel_bytes["bsr_spmm"] + 4 * 25)
        assert c.kernel_flops["bsr_spmm_gram"] == (
            c.kernel_flops["bsr_spmm"] + 7510 * 5 * 6)


def test_ingest_counts_occupied_tiles_and_meta_keeps_them():
    """Each orientation's ``occupied`` is its tiles with a nonzero entry,
    whichever way it was built, and a move to ``meta`` keeps it."""
    import numpy as np
    import scipy.sparse as sps

    from repro_torch.core.distributed import distribute_bsr
    from repro_torch.kernels.bsr import bsr_operand

    rng = np.random.default_rng(0)
    a = sps.random(300, 200, density=0.01, random_state=rng,
                   dtype=np.float32).tocsr()
    ops = [bsr_operand(a, bm=16, bk=32),
           bsr_operand(a.toarray(), bm=16, bk=32),
           distribute_bsr(a, (2, 2), (1, 0), bm=16, bk=16,
                          device="cpu").op]
    for op in ops:
        for b, b_meta in ((op.bsr, op.to("meta").bsr),
                          (op.bsr_t, op.to("meta").bsr_t)):
            want = int((b.tiles != 0).flatten(2).any(-1).sum())
            assert 0 < want < b.nrb * b.bcap
            assert b.occupied == b_meta.occupied == want
            assert b_meta.tiles.device.type == "meta"


# ---------------------------------------------------------------------------
# the sharded step's microbatches (the dry-run's ``ok`` cells run 4)
# ---------------------------------------------------------------------------

def test_sharded_step_microbatches_accumulate_the_whole_step():
    """On a 1x1 grid in f32: two microbatches give the one-microbatch
    step's loss and gradients within 1e-5 (the reference's f32 loss bar,
    ``tests/test_substrate.py:33``; only the summation order differs)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.training import sharding
    from repro_torch.training.optimizer import AdamW

    cfg = smoke_config(ARCHS["llama3.2-1b"])
    shape = ShapeSpec("t", 32, 4, "train")
    batch = api.make_batch(cfg, shape, seed=3, device="cpu")
    got = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            got[self.lr] = {k: g.clone() for k, g in grads.items()}
            return params, state

    losses = {}
    for m in (1, 2):
        model = api.init_params(cfg, 0, device="cpu")
        shards = sharding.shard_model(model, make_local_mesh(device="cpu"))
        opt = Capture(lr=float(m))
        _, _, loss = sharding.make_train_step(
            cfg, opt, shards, compute_dtype=torch.float32, microbatches=m)(
            model, opt.init(model), batch)
        losses[m] = float(loss)
    assert losses[2] == pytest.approx(losses[1], rel=1e-5, abs=1e-5)
    for k, g in got[1.0].items():
        torch.testing.assert_close(got[2.0][k], g, rtol=1e-5, atol=1e-6)


#: the grids of the reference's production dry-run
PRODUCTION = {"16x16": False, "2x16x16": True}


@pytest.fixture(scope="module")
def train_cells():
    """``train_4k`` of every architecture at :func:`_cut`'s depth on both
    production grids, each grid's cells in one fake world."""
    out = {}
    for grid, multi_pod in PRODUCTION.items():
        with dryrun.fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch, cfg in ARCHS.items():
                out[(grid, arch)] = dryrun.run_cell(
                    _cut(cfg), SHAPES["train_4k"], mesh, verbose=False)
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("grid", list(PRODUCTION))
def test_train_cells_are_ok_with_the_reference_bytes(train_cells, grid,
                                                     arch):
    """Every family's sharded step runs on the production grids: a rank's
    argument bytes are the reference's, its parameters, mu and nu three
    times its f32 parameter blocks; the new families' launcher init peaks
    under their step's peak."""
    rec = train_cells[(grid, arch)]
    assert rec["status"] == "ok", rec.get("error")
    sizes = MESHES[grid]
    assert rec["argument_bytes"] == _ref_argument_bytes(
        arch, "train_4k", sizes, cut=True)
    cfg = ARCHS[arch]
    params = _ref_params(arch, cut=True)
    pspecs = ref_api.param_pspecs(REF_ARCHS[arch], params, dryrun.RULES,
                                  mesh=types.SimpleNamespace(shape=sizes))
    assert rec["state_bytes"] == 3 * _ref_tree_bytes(params, pspecs, sizes)
    assert rec["flops"] > 0 and rec["collectives"]["all_reduce"]["calls"] > 0
    if cfg.family in ("moe", "hybrid", "ssm", "encdec"):
        assert 0 < rec["init_bytes"] < rec["bytes_per_device"]
    if cfg.family == "moe":
        assert rec["collectives"]["all_to_all"]["calls"] > 0


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "internvl2-76b"])
def test_launcher_init_peak_under_the_step_peak(arch):
    """The two ``train_4k`` cells the dry-run calls fitting on 16x16: the
    sharded launcher's init (``sharding.init_sharded``, counted on meta)
    peaks at the rank's parameter blocks and one whole leaf, under the
    rank's step peak, and nowhere near the whole f32 model."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        rec = dryrun.lower_cell(ARCHS[arch], SHAPES["train_4k"], mesh)
    from repro_torch.convert import _model

    shapes = [p.shape for p in _model(ARCHS[arch], "meta").parameters()]
    model_bytes = 4 * sum(math.prod(s) for s in shapes)
    leaf = 4 * max(math.prod(s) for s in shapes)
    blocks = rec["state_bytes"] // 3          # parameters, mu, nu alike
    assert rec["init_bytes"] <= blocks + leaf
    assert rec["init_bytes"] < rec["bytes_per_device"]
    assert rec["init_bytes"] < model_bytes / 16
