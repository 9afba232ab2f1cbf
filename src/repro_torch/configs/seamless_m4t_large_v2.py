"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.
24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206  [arXiv:2308.11596; hf]
The audio frontend is a stub: input_specs provide precomputed frame
embeddings.  24L is applied to BOTH encoder and decoder stacks."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    frontend="audio",
    dec_ratio=8,
    rope_theta=10000.0,
)
