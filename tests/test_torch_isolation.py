"""The port stands alone and never falls back.

* No file of ``src/repro_torch`` or ``chip_smoke.py`` imports ``jax`` or the
  reference package, and none ports the reference's kernel-failure
  fallback.
* Without a card, an entry point that was not asked for the CPU raises.
* A kernel wrapper handed CUDA tensors launches its kernel (here: fails to,
  since there is no nvcc / card) and never runs its plain version.
  That holds for the LM path's flash-attention wrapper too.
"""
import ast
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
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.core.topk import FusedReluTopK
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.nmf import EnforcedNMF
from repro_torch.serving import ServingEngine

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
    a, u = _operand()
    calls = {
        "bsr_spmm": lambda x: bsr_spmm(a, x),
        "gram": lambda x: gram(x),
        "project_mask": lambda x: project_mask(x, torch.tensor(0.5)),
        "relu_topk": lambda x: relu_topk(x, 7),
    }
    with pytest.raises(NotImplementedError, match="bf16"):
        calls[kernel](u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        calls[kernel](torch.ones((3, 30)).T)


def test_gram_wrapper_refuses_k_above_its_shared_memory(on_card):
    with pytest.raises(ValueError, match="k <="):
        gram(torch.ones((7, gram_mod.MAX_K + 1)))
    with pytest.raises(_Launched):
        gram(torch.ones((7, gram_mod.MAX_K)))
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
