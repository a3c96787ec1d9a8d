"""musicgen-medium — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

Published widths: 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
The EnCodec conv codec is a stub, as in the reference: batches carry
precomputed frame embeddings (64 positions); the 4-codebook delay
interleave is collapsed to a single token stream.  MusicGen's transformer
uses GELU MLPs.
"""

from repro_torch.configs.base import ArchConfig, _reduce_common

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio",
    num_frontend_tokens=64,
    block_pattern=("attn_mlp",),
)


def reduced() -> ArchConfig:
    return _reduce_common(CONFIG, num_kv_heads=4, num_frontend_tokens=8)
