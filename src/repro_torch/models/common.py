"""Shared model components: norms, activations, rotary embeddings, init.

Port of ``repro.models.common``.  Parameters are plain nested dicts of
tensors, as in the JAX package; initialisers draw from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s — a test that
needs both packages on the same weights carries them over with
:func:`repro_torch.weights.from_jax_params`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis in fp32, cast back to ``x.dtype``.
    ``scale`` broadcasts against ``x`` (a chain bank passes ``(C, 1, .., d)``)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head qk-norm: x (..., H, hd), scale broadcasting to (..., hd)."""
    return rms_norm(x, scale, eps)


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcasting to x's (..., S) axes —
    ``(S,)`` for one shared stream, ``(B, S)`` or ``(S_slots, 1)`` per row."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(generator, shape, dtype, scale: float | None = None,
               device="cpu") -> torch.Tensor:
    """N(0, std²) with std = 1/sqrt(fan_in) (or ``scale``), fan_in the
    second-to-last axis.  Leading axes (chains, layers) are batch axes."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _normal(generator, shape, dtype, std, device)


def embed_init(generator, shape, dtype, device="cpu") -> torch.Tensor:
    return _normal(generator, shape, dtype, 0.02, device)


def repeat_lead(values: torch.Tensor, lead, device="cpu") -> torch.Tensor:
    """A deterministic leaf: ``values`` repeated over the leading axes
    ``lead`` (chains, layers) as a tensor of its own, not a broadcast view
    (the SGLD update writes it in place)."""
    out = torch.empty(tuple(lead) + tuple(values.shape), dtype=values.dtype,
                      device=device)
    if out.device.type == "meta":
        return out
    return out.copy_(values.to(out.device).expand_as(out))


def _normal(generator, shape, dtype, std, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":  # shapes only: nothing to draw
        return out
    return out.normal_(0.0, std, generator=generator)


# ---------------------------------------------------------------------------
# chain-stacked projections
# ---------------------------------------------------------------------------
def per_chain(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain vector ``(C, n)`` shaped to broadcast against ``like``
    ``(C, ..., n)``."""
    return w.reshape(w.shape[0], *([1] * (like.dim() - 2)), w.shape[-1])


def bank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` per chain: x (C, ..., d), w (C, d, f) -> (C, ..., f).

    One batched GEMM over the chain axis.  ``w`` may be a strided view of a
    layer-stacked leaf (``stack[:, l]``): the GEMM reads it in place."""
    C, d = x.shape[0], x.shape[-1]
    y = torch.bmm(x.reshape(C, -1, d), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])
