"""qwen1.5-32b — dense MHA decoder with QKV bias [hf:Qwen/Qwen1.5 family].

Published widths: 64L d_model=5120 40H (MHA kv=40) d_ff=27392 vocab=152064, QKV bias.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B (family card; 32B table row per assignment)",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    block_pattern=("attn_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG, num_kv_heads=4)
