"""kimi-k2-1t-a32b — trillion-parameter MoE [arXiv:2501.kimi2 paper-table].

Published widths: 61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert)
vocab=163840, MoE 384 experts top-8 (+1 shared, DeepSeek-V3 lineage).
At 1T total parameters (2.09 TB in bf16) one card holds one layer of it:
one layer's 384 x 3 experts of 7168 x 2048 are 33.8 GB.  Its 2-D
sharding (``param_sharding="fsdp_tp"``) is the reference's; the port's
partition rules (:func:`repro_torch.models.common.partition_tree`) read it,
and nothing applies them to several cards yet.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2 (paper table)",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    block_pattern=("attn_moe",),
    param_sharding="fsdp_tp",
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG, head_dim=64, num_heads=4, num_kv_heads=2)
