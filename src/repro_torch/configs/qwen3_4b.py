"""qwen3-4b — dense GQA with per-head QK-norm [hf:Qwen/Qwen3-8B family card].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm.
Qwen3 uses head_dim=128 (decoupled from d_model/num_heads).
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG)
