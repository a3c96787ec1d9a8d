"""minicpm-2b — dense llama-like with WSD schedule [arXiv:2404.06395].

Published widths: 40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
MiniCPM's signature is the Warmup-Stable-Decay schedule (composed with the
SGLD gamma ceiling in train.py) and depth-scaled residuals (scale_depth=1.4).
"""

import math

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    residual_scale=1.4 / math.sqrt(40),
    tie_embeddings=True,
    block_pattern=("attn_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG, num_kv_heads=4)
