"""hymba-1.5b — hybrid parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Hymba runs attention and SSM heads *in parallel inside each block*; every
layer uses the sliding-window attention (window 1024), as in the reference.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    sliding_window=1024,
    block_pattern=("hymba_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG, num_heads=4, num_kv_heads=2, head_dim=64)
