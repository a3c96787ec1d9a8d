"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct].

Published widths: 32L d_model=4096 32H (GQA kv=8) d_ff=6400(per expert) vocab=32064,
MoE 16e top-2.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    block_pattern=("attn_moe",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG)
