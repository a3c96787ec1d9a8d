"""internvl2-1b — VLM: InternViT + Qwen2-0.5B-style LM [arXiv:2404.16821].

Published widths: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The vision frontend (InternViT + MLP projector) is a stub, as in the
reference: batches carry precomputed patch embeddings (256 positions of
width ``FRONTEND_DIM``), projected and prepended to the text stream; the
language decoder is implemented.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,  # Qwen2 LM backbone uses QKV bias
    frontend="vision",
    num_frontend_tokens=256,
    block_pattern=("attn_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG, num_frontend_tokens=16)
