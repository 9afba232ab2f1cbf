"""Architecture registry and assigned input shapes (port of
``repro.configs``): every architecture of the reference's registry, in
its order — the seamless encoder-decoder (``encdec``), the dense
decoders, the internvl2 language model (``vlm``), the mixtures of experts
(``moe``), the Mamba2 hybrid (``hybrid``) and xLSTM (``ssm``); and the
paper's NMF experiment configurations (``NMF_CONFIGS``, a copy of the
reference's).

Each architecture has its own module (``repro_torch.configs.<id>`` with
dashes mapped to underscores) exporting ``CONFIG``, field for field the
reference's.  ``smoke_config`` gives the same reduced variants as the
reference's for every family, and ``cell_supported`` which (architecture
x shape) cells are defined, the reference's answer for all 40.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.common import ArchConfig

from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from repro_torch.configs.codeqwen1_5_7b import CONFIG as codeqwen1_5_7b
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b
from repro_torch.configs.phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from repro_torch.configs.deepseek_coder_33b import CONFIG as deepseek_coder_33b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe_1b_7b
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.xlstm_125m import CONFIG as xlstm_125m
from repro_torch.configs.internvl2_76b import CONFIG as internvl2_76b
from repro_torch.configs.nmf_paper import NMF_CONFIGS

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        seamless_m4t_large_v2,
        codeqwen1_5_7b,
        llama3_2_1b,
        phi4_mini_3_8b,
        deepseek_coder_33b,
        qwen3_moe_235b_a22b,
        olmoe_1b_7b,
        zamba2_7b,
        xlstm_125m,
        internvl2_76b,
    ]
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is a defined cell, and why not: the
    reference's rule (``repro.configs.cell_supported``)."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, ("long_500k needs sub-quadratic attention; pure "
                       "full-attention arch (skip per assignment)")
    return True, ""


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kv_ratio = max(cfg.n_heads // cfg.n_kv_heads, 1)
    n_heads = 4
    overrides = dict(
        n_layers=2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(n_heads // kv_ratio, 1),
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
    )
    if cfg.family == "moe":
        overrides.update(n_experts=8, moe_top_k=2)
    if cfg.family in ("hybrid", "ssm"):
        overrides.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        overrides.update(n_layers=5, attn_every=2)
    if cfg.family == "encdec":
        overrides.update(n_enc_layers=2)
    if cfg.name.startswith("xlstm"):
        overrides.update(n_layers=4, slstm_at=(1, 3), head_dim=None)
    if cfg.family == "vlm":
        overrides.update(n_patches=8)
    return dataclasses.replace(cfg, **overrides)


__all__ = ["ARCHS", "NMF_CONFIGS", "SHAPES", "ShapeSpec", "cell_supported",
           "smoke_config"]
