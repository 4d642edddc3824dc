"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

24L d_model=1024 4H d_ff=0 vocab=50304. Superblock = 7 mLSTM + 1 sLSTM
(xLSTM[7:1]); no separate FFN (d_ff=0: the mixers carry their own
projections). Constant-size recurrent state per sequence, no KV growth.
"""
import torch

from repro_torch.models.common import ModelConfig, XLSTMCfg

FULL = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMCfg(chunk=64, proj_factor=2.0, conv=4),
    pos="none",
)

SMOKE = FULL.replace(
    n_layers=8,
    d_model=64,
    n_heads=4,
    vocab_size=512,
    xlstm=XLSTMCfg(chunk=8, proj_factor=2.0, conv=4),
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    remat="none",
    ce_chunks=2,
)

SKIP_SHAPES = {}
