"""Selective state-space heads in the SSD (Mamba-2) form, over a chain bank
(port of ``repro.models.ssm``).

Scalar decay per head per step, so a sequence chunk is two matmul-shaped
contractions (the intra-chunk "attention-like" term and the inter-chunk
state carry) and the recurrence runs only across chunks: a Python loop over
``S / chunk`` chunks, as the reference's ``lax.scan``.  The reference
computes the scan in plain ``jnp``, outside any Pallas kernel; here it is
plain torch.

Parameters carry the chain axis ``(C, ...)`` (a layer stack adds ``L``
after it), activations are ``(C, B, S, d)``.  Past the projections the scan
has no parameters but the decay rate, so chains and rows fold into one
batch axis of ``C * B``.

Shapes: inner dim ``di = 2 * d_model``, heads ``H`` (the attention heads),
head dim ``p = di / H``, state ``n`` (``cfg.ssm_state``), conv taps ``K``
(``cfg.ssm_conv``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rng import _xla_log
from repro_torch.models.common import (
    bank_matmul,
    dense_init,
    per_chain,
    repeat_lead,
    rms_norm,
)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm(generator, cfg, dtype, lead=(), device="cpu") -> dict:
    """Random SSD parameters with leading axes ``lead``.  The deterministic
    leaves are the reference's bit for bit: ``a_log = log(1..H)`` (XLA's
    float32 log), ``d_skip`` and ``norm`` ones, ``conv_b`` zeros."""
    d, H, n, K = cfg.d_model, cfg.num_heads, cfg.ssm_state, cfg.ssm_conv
    di = 2 * d
    lead = tuple(lead)
    dev = torch.device(device)
    dt_bias = torch.empty(lead + (H,), dtype=torch.float32, device=dev)
    if dev.type != "meta":
        dt_bias.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
        dt_bias = torch.log(torch.expm1(torch.exp(dt_bias)))
    return {
        "in_proj": dense_init(generator, lead + (d, 2 * di), dtype, device=dev),
        "conv_w": dense_init(generator, lead + (K, di), dtype, scale=1.0 / math.sqrt(K),
                             device=dev),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "bc_proj": dense_init(generator, lead + (di, 2 * n), dtype, device=dev),
        "dt_w": dense_init(generator, lead + (di, H), dtype, device=dev),
        "dt_bias": dt_bias,
        "a_log": repeat_lead(_xla_log(torch.arange(1, H + 1, dtype=torch.float32)), lead, dev),
        "d_skip": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "norm": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, lead + (di, d), dtype, device=dev),
    }


class SSMState(NamedTuple):
    h: torch.Tensor     # (C, B, H, p, n) float32
    conv: torch.Tensor  # (C, B, K-1, di) the last inputs of the depthwise conv


def init_ssm_state(cfg, batch: int, dtype, lead, device="cpu") -> SSMState:
    """Zero decode state for ``batch`` rows; ``lead`` are the axes before
    the rows (the chains, and a layer stack's ``L`` before them)."""
    di = 2 * cfg.d_model
    H, n, K = cfg.num_heads, cfg.ssm_state, cfg.ssm_conv
    lead = tuple(lead) + (batch,)
    return SSMState(
        h=torch.zeros(lead + (H, di // H, n), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (K - 1, di), dtype=dtype, device=device),
    )


def _depthwise_conv(x, conv_w, conv_b, conv_state=None):
    """Causal depthwise conv along the sequence: x (C, B, S, di), conv_w
    (C, K, di), conv_b (C, di).  The taps are summed in x's dtype, in tap
    order.  Returns (out, the last K-1 inputs)."""
    C, B, S, di = x.shape
    K = conv_w.shape[1]
    if conv_state is None:
        pad = x.new_zeros(C, B, K - 1, di)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=2)
    out = xp[:, :, 0:S] * conv_w[:, 0][:, None, None]
    for i in range(1, K):
        out = out + xp[:, :, i:i + S] * conv_w[:, i][:, None, None]
    new_state = xp[:, :, S:] if K > 1 else pad
    return out + conv_b[:, None, None], new_state


def _ssd_chunk_scan(xh, bt, ct, dt, a, chunk: int):
    """Chunked SSD scan.

    xh: (N, S, H, p); bt, ct: (N, S, n); dt: (N, S, H) (after the
    softplus); a: the negative decay rate, broadcasting against dt.
    Returns y: (N, S, H, p) float32 and the final state h: (N, H, p, n)."""
    N, S, H, p = xh.shape
    n = bt.shape[-1]
    c = min(chunk, S)
    assert S % c == 0, f"seq {S} not divisible by ssm chunk {c}"

    la = dt * a  # log decay per step (negative), (N, S, H)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=xh.device))
    h = torch.zeros(N, H, p, n, dtype=torch.float32, device=xh.device)
    ys = []
    for j in range(S // c):
        sl = slice(j * c, (j + 1) * c)
        xb = xh[:, sl].float()
        bb, cb = bt[:, sl].float(), ct[:, sl].float()
        dtb = dt[:, sl]
        seg = torch.cumsum(la[:, sl], dim=1)  # (N, c, H) log decay from the chunk start
        # intra-chunk: scores[t, s] = (C_t . B_s) exp(seg_t - seg_s) dt_s, s <= t
        # masked before the exp (the reference masks after it): the same
        # forward, and no 0 * inf = NaN in the backward where seg_t - seg_s
        # of a masked pair (s > t) overflows the exp
        logw = seg[:, :, None, :] - seg[:, None, :, :]  # (N, c, c, H)
        w = torch.exp(torch.where(tri[None, :, :, None], logw, -math.inf))
        scores = torch.einsum("btn,bsn->bts", cb, bb)[..., None] * w
        scores = scores * dtb[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", scores, xb)
        # inter-chunk: y_t += C_t . (exp(seg_t) h)
        y_inter = torch.einsum("btn,bhpn->bthp", cb, h) * torch.exp(seg)[..., None]
        # state to the chunk's end: exp(seg_end) h + sum_s exp(seg_end - seg_s) dt_s x_s B_s
        seg_end = seg[:, -1:, :]
        w_end = torch.exp(seg_end - seg) * dtb  # (N, c, H)
        h = (torch.exp(seg_end[:, 0, :])[:, :, None, None] * h
             + torch.einsum("bch,bchp,bcn->bhpn", w_end, xb, bb))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def apply_ssm(params, x, cfg, *, chunk: int = 64, state: SSMState | None = None):
    """Full-sequence SSD block over a chain bank: x (C, B, S, d) -> (C, B,
    S, d).  With ``state`` (decode) S is 1, the recurrence is one step, and
    the result is ``(out, new state)``."""
    C, B, S, d = x.shape
    di = 2 * d
    H = cfg.num_heads
    p = di // H

    xi, z = bank_matmul(x, params["in_proj"]).chunk(2, dim=-1)  # (C, B, S, di)
    xi, new_conv = _depthwise_conv(xi, params["conv_w"], params["conv_b"],
                                   None if state is None else state.conv)
    xi = F.silu(xi)
    bt, ct = bank_matmul(xi, params["bc_proj"]).chunk(2, dim=-1)  # (C, B, S, n)
    dt = softplus(bank_matmul(xi, params["dt_w"]).float()
                  + per_chain(params["dt_bias"], xi))  # (C, B, S, H)
    a = -torch.exp(params["a_log"])  # (C, H), negative
    xh = xi.reshape(C, B, S, H, p)

    if state is None:
        n = bt.shape[-1]
        y, _ = _ssd_chunk_scan(
            xh.reshape(C * B, S, H, p), bt.reshape(C * B, S, n),
            ct.reshape(C * B, S, n), dt.reshape(C * B, S, H),
            a[:, None, None, :].expand(C, B, 1, H).reshape(C * B, 1, H), chunk)
        y = y.reshape(C, B, S, H, p)
        new_state = None
    else:
        # one step: h' = exp(dt a) h + dt x (x) B ; y = h' . C
        la = torch.exp(dt[:, :, 0] * a[:, None, :])  # (C, B, H)
        xb = torch.einsum("cbhp,cbn->cbhpn", xh[:, :, 0].float(), bt[:, :, 0].float())
        h_new = la[..., None, None] * state.h + dt[:, :, 0][..., None, None] * xb
        y = torch.einsum("cbhpn,cbn->cbhp", h_new, ct[:, :, 0].float())[:, :, None]
        new_state = SSMState(h=h_new, conv=new_conv)

    y = y + params["d_skip"][:, None, None, :, None] * xh.float()
    y = y.reshape(C, B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), per_chain(params["norm"], y), cfg.norm_eps)
    out = bank_matmul(y, params["out_proj"])
    if state is None:
        return out
    return out, new_state
