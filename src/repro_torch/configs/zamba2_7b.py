"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
[arXiv:2411.15242].  81 Mamba2 layers; the single shared attn+MLP block is
applied after every 6th Mamba layer (13 applications + 3-layer tail)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    supports_long=True,
    rope_theta=10000.0,
)
