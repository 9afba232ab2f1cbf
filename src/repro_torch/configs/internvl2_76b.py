"""internvl2-76b [vlm] — LM backbone 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 — InternViT frontend is a STUB (precomputed patch
embeddings, n_patches=1024)  [arXiv:2404.16821]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    frontend="vision",
    n_patches=1024,
    rope_theta=500000.0,
)
