"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0 means the blocks
carry their own up/down projections (mLSTM pre-up-projection factor 2,
sLSTM post-block gated FFN 4/3) — no separate transformer MLP.  Pattern is
xLSTM[7:1]: one sLSTM block per 8 layers, rest mLSTM (48 = 6 periods).
Attention-free: no KV cache, only recurrent decode state.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    block_pattern=("mlstm",) * 7 + ("slstm",),
)


def reduced() -> ArchConfig:
    return _reduce_common(
        CONFIG,
        num_heads=2, num_kv_heads=2, head_dim=128, d_ff=0,
        block_pattern=("mlstm", "slstm"),
    )
