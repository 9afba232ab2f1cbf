"""The port stands alone and never falls back.

* No file of ``src/repro_torch`` or ``chip_smoke.py`` imports ``jax`` or the
  reference package, and none ports the reference's kernel-failure
  fallback.
* Without a card, an entry point that was not asked for the CPU raises.
* A kernel wrapper handed CUDA tensors launches its kernel (here: fails to,
  since there is no nvcc / card) and never runs its plain version.
  That holds for the LM path's flash-attention wrapper too.
* The LM training half (the loss, the train step, the train launcher) takes
  the plain attention path its step maker names, never the flash kernel,
  and its entry points raise without a card too; so do the moe family's.
* The grid's ``all_to_all`` stages through the host under gloo because the
  initialized backend says so, never because a call failed.
"""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch import default_device, resolve_device
from repro_torch.kernels import _build, bsr, ref
from repro_torch.kernels import bsr_spmm as spmm_mod
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import project_mask as mask_mod
from repro_torch.kernels.bsr_spmm import bsr_spmm
from repro_torch.kernels.fused import bsr_spmm_gram
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import project_mask, relu_topk
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, smoke_config
from repro_torch.core.topk import FusedReluTopK
from repro_torch.launch import serve, train
from repro_torch.models import api
from repro_torch.nmf import EnforcedNMF
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamW

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(REPO)} imports {name}")


def test_no_kernel_fallback_in_port():
    for path in PORT_FILES:
        names = {n.name for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        assert "_with_kernel_fallback" not in names, path
        assert "_demote_operand" not in names, path


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnforcedNMF()
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert EnforcedNMF(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("solver", ["streaming", "sequential"])
def test_streaming_and_sequential_entry_points_raise_without_a_card(
        monkeypatch, tmp_path, solver):
    """The new solvers, ``partial_fit`` and a corpus directory need the
    card unless the CPU is asked for; on the CPU they run."""
    from repro_torch.data import open_corpus, write_corpus
    from repro_torch.nmf import NMFConfig

    a = torch.rand((12, 10))
    path = write_corpus(a, tmp_path / "c", chunk_docs=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnforcedNMF(NMFConfig(k=2, solver=solver))
    cfg = NMFConfig(k=2, iters=2, solver=solver)
    model = EnforcedNMF(cfg, device="cpu").fit(
        open_corpus(path) if solver == "streaming" else a)
    assert model.u_.device.type == "cpu"
    model.partial_fit(a[:, :4])
    assert model.n_docs_seen_ == 14


class _Launched(Exception):
    """Raised where a wrapper would build or launch its kernel."""


def _launch(*args, **kwargs):
    raise _Launched


def _plain(*args, **kwargs):
    raise AssertionError("a wrapper ran its plain version for a CUDA tensor")


@pytest.fixture
def on_card(monkeypatch):
    """Pretend every tensor is on the card; building a kernel or running a
    plain version is then observable."""
    monkeypatch.setattr(_build, "on_card", lambda *tensors: True)
    for name in ("bsr_spmm_ref", "bsr_spmm_gram_ref", "gram_ref",
                 "project_mask_ref", "relu_topk_ref", "flash_attention_ref"):
        monkeypatch.setattr(ref, name, _plain)
    monkeypatch.setattr(spmm_mod, "_lib", _launch)
    monkeypatch.setattr(flash_mod, "_lib", _launch)
    monkeypatch.setattr(gram_mod, "_lib", _launch)
    monkeypatch.setattr(mask_mod, "_lib", _launch)


def _operand():
    a = torch.zeros((40, 30))
    a[:5, :7] = 1.0
    return bsr.bsr_from_dense(a, bm=32, bk=32), torch.ones((30, 3))


@pytest.mark.parametrize("kernel", ["bsr_spmm", "bsr_spmm_gram", "gram",
                                    "project_mask", "relu_topk",
                                    "FusedReluTopK"])
def test_wrapper_never_runs_plain_version_on_card(on_card, kernel):
    a, u = _operand()
    calls = {
        "bsr_spmm": lambda: bsr_spmm(a, u),
        "bsr_spmm_gram": lambda: bsr_spmm_gram(a, u),
        "gram": lambda: gram(u),
        "project_mask": lambda: project_mask(u, torch.tensor(0.5)),
        "relu_topk": lambda: relu_topk(u, 7),
        "FusedReluTopK": lambda: FusedReluTopK(t=7)(u),
    }
    with pytest.raises(_Launched):
        calls[kernel]()


@pytest.mark.parametrize("kernel", ["bsr_spmm", "gram", "project_mask",
                                    "relu_topk"])
def test_wrapper_rejects_bf16_and_bad_layout_on_card(on_card, kernel):
    """bf16 operands go to the kernel as f32 ones do (the kernels take
    bf16); tiles and factor of two dtypes, and a strided layout, are refused
    before any launch."""
    a, u = _operand()
    a16 = dataclasses.replace(a, tiles=a.tiles.to(torch.bfloat16))
    calls = {
        "bsr_spmm": lambda x: bsr_spmm(
            a16 if x.dtype == torch.bfloat16 else a, x),
        "gram": lambda x: gram(x),
        "project_mask": lambda x: project_mask(x, torch.tensor(0.5)),
        "relu_topk": lambda x: relu_topk(x, 7),
    }
    with pytest.raises(_Launched):
        calls[kernel](u.to(torch.bfloat16))
    if kernel == "bsr_spmm":
        with pytest.raises(TypeError, match="one dtype"):
            bsr_spmm(a, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        calls[kernel](torch.ones((3, 30)).T)


def test_gram_wrapper_refuses_k_above_its_shared_memory(on_card):
    """There is no k limit any more: at k = 225 and 256 (tiled output) the
    wrapper goes to its kernel and never to its plain version."""
    assert not hasattr(gram_mod, "MAX_K")
    for k in (224, 225, 256):
        with pytest.raises(_Launched):
            gram(torch.ones((7, k)))
    assert _build.launch_counts()["gram"] == 0


def test_wrapper_rejects_mixed_devices():
    a, u = _operand()
    with pytest.raises(ValueError, match="several devices"):
        bsr_spmm(a, u.to("meta"))


def test_flash_wrapper_never_runs_plain_version_on_card(on_card):
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(_Launched):
        flash_mod.flash_attention(q, kv, kv, groups=2)
    with pytest.raises(ValueError, match="head size"):
        flash_mod.flash_attention(q[..., :8], kv[..., :8], kv[..., :8],
                                  groups=2)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_mod.flash_attention(q.requires_grad_(), kv, kv, groups=2)
    assert _build.launch_counts()["flash_attention"] == 0


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    cfg = smoke_config(ARCHS["llama3.2-1b"])
    model = api.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.make_batch(cfg, SHAPES["prefill_32k"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
    assert ServingEngine(cfg, model, device="cpu").device.type == "cpu"


def test_relu_topk_wrapper_refuses_what_the_kernel_does_not_take(on_card):
    u = torch.ones((30, 3))
    with pytest.raises(ValueError, match="num_steps"):
        relu_topk(u, 7, num_steps=-1)
    with pytest.raises(ValueError, match="non-empty"):
        relu_topk(torch.ones((0, 3)), 1)
    with pytest.raises(TypeError, match="float32"):
        relu_topk(u.double(), 7)
    with pytest.raises(_Launched):
        relu_topk(u, 7, num_steps=0)
    assert _build.launch_counts()["relu_topk"] == 0


def test_train_entry_points_raise_without_a_card(monkeypatch):
    cfg = smoke_config(ARCHS["llama3.2-1b"])
    shape = SHAPES["train_4k"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.synthetic_batch(cfg, shape, 0)
    batch = train.synthetic_batch(cfg, ShapeSpec("t", 16, 2, "train"), 0,
                                  device="cpu")
    assert batch["tokens"].device.type == "cpu"


def test_train_step_takes_the_plain_path_and_prefill_the_kernel(on_card):
    """The step makers name the attention path: a train step launches
    nothing (plain attention, as the reference trains), a prefill step the
    flash kernel."""
    cfg = smoke_config(ARCHS["llama3.2-1b"])
    model = api.init_params(cfg, 0, device="cpu")
    batch = api.make_batch(cfg, ShapeSpec("t", 16, 2, "train"), 1,
                           device="cpu")
    opt = AdamW()
    _, state, loss = api.make_train_step(cfg, opt)(model, opt.init(model),
                                                   batch)
    assert torch.isfinite(loss) and int(state.step) == 1
    with pytest.raises(_Launched):
        api.make_prefill_step(cfg)(model, {"tokens": batch["tokens"]})
    assert _build.launch_counts()["flash_attention"] == 0


def test_the_moe_modules_are_held_to_the_import_rule():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/models/moe.py",
            "src/repro_torch/configs/olmoe_1b_7b.py",
            "src/repro_torch/configs/qwen3_moe_235b_a22b.py"} <= names


def test_all_to_all_stages_by_the_backend_never_by_a_caught_failure():
    """``NMFMesh.all_to_all`` copies a CUDA tensor through the host under
    gloo because the initialized backend says so: the method catches
    nothing."""
    from repro_torch.launch import mesh as mesh_mod

    tree = ast.parse(Path(mesh_mod.__file__).read_text())
    method = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == "all_to_all")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(method))
    assert "get_backend" in ast.unparse(method)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_train_step_takes_the_plain_path_and_prefill_the_kernel(on_card,
                                                                    arch):
    cfg = smoke_config(ARCHS[arch])
    model = api.init_params(cfg, 0, device="cpu")
    batch = api.make_batch(cfg, ShapeSpec("t", 16, 2, "train"), 1,
                           device="cpu")
    opt = AdamW()
    _, state, loss = api.make_train_step(cfg, opt)(model, opt.init(model),
                                                   batch)
    assert torch.isfinite(loss) and int(state.step) == 1
    with pytest.raises(_Launched):
        api.make_prefill_step(cfg)(model, {"tokens": batch["tokens"]})
    assert _build.launch_counts()["flash_attention"] == 0


def test_moe_entry_points_raise_without_a_card(monkeypatch):
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    model = api.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "olmoe-1b-7b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "1"])


EXAMPLE_FILES = sorted((REPO / "examples").glob("torch_*.py"))


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_port_has_its_examples():
    assert {p.name for p in EXAMPLE_FILES} >= {
        "torch_quickstart.py", "torch_topic_modeling_pipeline.py",
        "torch_serving.py", "torch_lm_training.py"}


@pytest.mark.parametrize("path", EXAMPLE_FILES, ids=lambda p: p.name)
def test_examples_import_neither_jax_nor_reference(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(REPO)} imports {name}")


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []),
    ("torch_topic_modeling_pipeline", ["--terms", "60", "--docs", "30",
                                       "--iters", "4", "--rounds", "2",
                                       "--t-u", "30", "--t-v", "40"]),
    ("torch_topic_modeling_pipeline", ["--terms", "60", "--docs", "30",
                                       "--iters", "4", "--rounds", "2",
                                       "--t-u", "30", "--t-v", "40",
                                       "--stream"]),
    ("torch_serving", []),
    ("torch_lm_training", ["--steps", "1"]),
    ("torch_lm_training", ["--steps", "1", "--arch", "olmoe-1b-7b",
                           "--compress"]),
], ids=["quickstart", "pipeline", "pipeline-stream", "serving", "training",
        "training-compress"])
def test_examples_raise_without_a_card_unless_asked_for_the_cpu(
        monkeypatch, tmp_path, capsys, name, argv):
    """Each example's ``main`` needs the card; ``--device cpu`` runs it on
    the plain versions, launching no kernel."""
    mod = _example(name)
    if name == "torch_topic_modeling_pipeline":
        argv = argv + ["--ckpt", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    assert not (tmp_path / "factors.npz").exists()
    _build.reset_launch_counts()
    got = mod.main(argv + ["--device", "cpu"])
    assert got["device"] == "cpu"
    assert sum(_build.launch_counts().values()) == 0
    assert "cpu" in capsys.readouterr().out
