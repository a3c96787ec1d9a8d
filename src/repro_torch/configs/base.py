"""Architecture config dataclass and the registry (port of
``repro.configs.base``).

Only the fields and helpers the ported slices need are kept; the port
registers the architectures it can run (the dense ``attn_mlp`` stack), so a
request for another id fails at lookup instead of deep inside the model.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

#: architectures the port implements (module name under repro_torch.configs)
ARCH_IDS = ["qwen3_4b"]

# canonical dashed ids (CLI) -> module names
ALIASES = {"qwen3-4b": "qwen3_4b"}


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

    block_pattern: tuple = ("attn_mlp",)  # cycled over layers

    # misc
    act: str = "silu"
    residual_scale: float = 1.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    frontend: Optional[str] = None  # None | "vision" | "audio"
    dtype: str = "bfloat16"

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


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape x step kind (``repro.configs.base.ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


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


def _reduce_common(cfg: ArchConfig, **over) -> ArchConfig:
    """Shared recipe for CPU smoke variants: 2 layers, d_model 256."""
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
    kw.update(over)
    return replace(cfg, name=cfg.name + "-reduced", **kw)
