"""Architecture config dataclass and the registry (port of
``repro.configs.base``).

Only the fields and helpers the ported slices need are kept (of the
sharding fields, ``param_sharding``, which the partition rules read; none
of the reference's performance switches); the port registers every
architecture of the reference:
the attention stacks (``attn_mlp``, ``attn_moe``, with the vision and audio
frontend stubs), the hybrid attention + SSD stack (``hymba_mlp``) and the
heterogeneous xLSTM stack (``mlstm`` / ``slstm``).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

#: architectures the port implements (module name under repro_torch.configs)
ARCH_IDS = [
    "hymba_1p5b",
    "minicpm_2b",
    "internvl2_1b",
    "kimi_k2_1t_a32b",
    "phi35_moe_42b_a6p6b",
    "xlstm_1p3b",
    "qwen3_4b",
    "stablelm_12b",
    "qwen15_32b",
    "musicgen_medium",
]

# canonical dashed ids (CLI) -> module names
ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "minicpm-2b": "minicpm_2b",
    "internvl2-1b": "internvl2_1b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6p6b",
    "xlstm-1.3b": "xlstm_1p3b",
    "qwen3-4b": "qwen3_4b",
    "stablelm-12b": "stablelm_12b",
    "qwen1.5-32b": "qwen15_32b",
    "musicgen-medium": "musicgen_medium",
}


@dataclass(frozen=True)
class ArchConfig:
    """Architecture hyper-parameters (transformer backbone)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    source: str                    # citation for the config numbers
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # static window if set

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    router_aux_coef: float = 0.01

    # SSM (mamba-style heads: hymba) / xLSTM
    ssm_state: int = 0
    ssm_conv: int = 4
    block_pattern: tuple = ("attn_mlp",)  # cycled over layers

    # misc
    act: str = "silu"
    residual_scale: float = 1.0     # MiniCPM depth-scaled residuals
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    frontend: Optional[str] = None  # None | "vision" | "audio"
    num_frontend_tokens: int = 0    # prepended stub-embedding positions
    dtype: str = "bfloat16"

    # distribution: the layout :func:`repro_torch.models.common.partition_tree`
    # gives ("tp" | "fsdp_tp", 2-D for trillion-scale | "fsdp_full")
    param_sharding: str = "tp"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads={self.num_heads} is not a multiple "
                             f"of num_kv_heads={self.num_kv_heads}")

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Exact parameter count of one chain, from the port's own init on
        the ``meta`` device (no memory, no device)."""
        from repro_torch.models.transformer import init_params
        from repro_torch.utils import tree_leaves

        params = init_params(self, device="meta")
        return sum(t.numel() for t in tree_leaves(params))

    def active_param_count(self) -> int:
        """Parameters one token activates (MoE: only its routed experts)."""
        full = self.param_count()
        if self.num_experts == 0:
            return full
        expert_p = 3 * self.d_model * self.d_ff
        n_moe_layers = sum(
            1 for i in range(self.num_layers)
            if self.block_pattern[i % len(self.block_pattern)] == "attn_moe")
        inactive = ((self.num_experts - self.experts_per_token)
                    * expert_p * n_moe_layers)
        return int(full - inactive)


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape x step kind (``repro.configs.base.ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"
    num_microbatches: int = 1


#: the assigned input shapes (the reference's ``SHAPES``)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train", num_microbatches=4),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"the port has no architecture {name!r} yet "
                         f"(implemented: {sorted(ALIASES)})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_arch(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_archs() -> list[ArchConfig]:
    return [get_arch(a) for a in ARCH_IDS]


def _reduce_common(cfg: ArchConfig, **over) -> ArchConfig:
    """Shared recipe for CPU smoke variants: 2 layers, d_model 256, at most
    4 experts (top-2, one shared expert at most)."""
    kw = dict(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2,
                  num_shared_experts=min(cfg.num_shared_experts, 1))
    kw.update(over)
    return replace(cfg, name=cfg.name + "-reduced", **kw)
