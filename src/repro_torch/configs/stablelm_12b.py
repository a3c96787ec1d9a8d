"""stablelm-12b — dense GQA decoder [hf:stabilityai/stablelm-2-12b lineage].

Published widths: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b (scaled per assignment)",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    block_pattern=("attn_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG)
