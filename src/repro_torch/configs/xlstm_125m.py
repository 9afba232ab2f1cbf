"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks  [arXiv:2405.04517].  mLSTM everywhere except sLSTM at
layers (5, 11) (~the paper's 7:1 mix at this depth); d_ff=0 means no separate
FFN (projection factor 2 lives inside the mLSTM block)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_at=(5, 11),
    supports_long=True,
)
