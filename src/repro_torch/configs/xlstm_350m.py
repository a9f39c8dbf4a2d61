"""xLSTM-350M: alternating mLSTM / sLSTM blocks [arXiv:2405.04517;
unverified]. d_ff=0: xLSTM blocks carry their own up/down projections
(mLSTM pf=2 pre-up-projection, sLSTM pf=4/3 post-up-projection)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=256,
    block_pattern=("mlstm", "slstm"),
    source="arXiv:2405.04517; unverified",
)
