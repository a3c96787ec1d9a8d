"""Selective state-space heads in the SSD (Mamba-2) form, over a chain bank
(port of ``repro.models.ssm``).

Scalar decay per head per step, so a sequence chunk is two matmul-shaped
contractions (the intra-chunk "attention-like" term and the inter-chunk
state carry) and the recurrence runs only across chunks: a Python loop over
``S / chunk`` chunks, as the reference's ``lax.scan`` (on ``meta`` one
chunk, counted ``S / chunk`` times by :func:`~repro_torch.analysis.cost.
repeated`).  The reference
computes the scan in plain ``jnp``, outside any Pallas kernel; here it is
plain torch.

Parameters carry the chain axis ``(C, ...)`` (a layer stack adds ``L``
after it), activations are ``(C, B, S, d)``.  Past the projections the scan
has no parameters but the decay rate, so chains and rows fold into one
batch axis of ``C * B``.

Shapes: inner dim ``di = 2 * d_model``, heads ``H`` (the attention heads),
head dim ``p = di / H``, state ``n`` (``cfg.ssm_state``), conv taps ``K``
(``cfg.ssm_conv``).

On a model axis (``tp``, a :class:`~repro_torch.models.common.ModelAxis`
whose ``ssm`` is set) a rank computes a run of ``di / m`` channels: the
recurrence is independent a channel given ``dt``, B and C, so the split is
exact even where it cuts a head (hymba-1.5b's 25 heads of 128 channels on
2 or 16 ranks).  The rank takes its channels' columns of ``in_proj``'s
``x`` and ``z`` halves, its conv channels and its rows of ``bc_proj`` and
``dt_w``; B, C and ``dt`` contract over every channel, so the ranks'
partial products (``2n + H`` wide, float32) are all-reduced once; the
heads its channels touch run the scan (a cut head padded with zero
channels, which add nothing), the gated RMSNorm's sum of squares is
all-reduced, and ``out_proj`` is row-parallel.  The reference's specs
split ``in_proj``'s ``[x | z]`` columns, ``conv_w``'s taps and the heads
of ``dt_w`` and the per-head vectors, which are not a run of channels: a
rank gathers those leaves whole where the layer runs and keeps the
reference's blocks at rest (see ``ModelAxis.ssm_gather``) — but for
``in_proj`` in a decode step, where it gathers the ``[x | z]`` columns its
block gives the step's rows instead (``2 di`` a row, against ``d · 2 di``
of weights).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.analysis.cost import repeated
from repro_torch.kernels.rng import _xla_log
from repro_torch.models.common import (
    bank_matmul,
    dense_init,
    normal_over,
    per_chain,
    repeat_lead,
    rms_norm,
    split_keys,
    uniform_init,
)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm(keys, cfg, dtype, device="cpu") -> dict:
    """The reference's ``init_ssm`` under each key of ``keys`` (``lead +
    (2,)``): ``split(key, 8)``, the drawn leaves its numbers.  The
    deterministic leaves are the reference's bit for bit: ``a_log =
    log(1..H)`` (XLA's float32 log), ``d_skip`` and ``norm`` ones,
    ``conv_b`` zeros.  ``dt_bias`` is ``log(expm1(exp(u)))`` of the
    reference's uniform ``u``, in torch's float32 ``exp``, ``expm1`` and
    ``log`` (ATen's and XLA's may part in the last ulp)."""
    d, H, n, K = cfg.d_model, cfg.num_heads, cfg.ssm_state, cfg.ssm_conv
    di = 2 * d
    lead = tuple(keys.shape[:-1])
    dev = torch.device(device)
    ks = split_keys(keys, 8)
    dt_bias = uniform_init(ks[4], lead + (H,), math.log(1e-3), math.log(1e-1), dev)
    if dev.type != "meta":
        dt_bias = torch.log(torch.expm1(torch.exp(dt_bias)))
    return {
        "in_proj": dense_init(ks[0], lead + (d, 2 * di), dtype, device=dev),
        "conv_w": normal_over(ks[1], lead + (K, di), dtype, math.sqrt(K), device=dev),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "bc_proj": dense_init(ks[2], lead + (di, 2 * n), dtype, device=dev),
        "dt_w": dense_init(ks[3], lead + (di, H), dtype, device=dev),
        "dt_bias": dt_bias,
        "a_log": repeat_lead(_xla_log(torch.arange(1, H + 1, dtype=torch.float32)), lead, dev),
        "d_skip": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "norm": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(ks[5], lead + (di, d), dtype, device=dev),
    }


class SSMState(NamedTuple):
    h: torch.Tensor     # (C, B, H, p, n) float32
    conv: torch.Tensor  # (C, B, K-1, di) the last inputs of the depthwise conv


def channel_heads(cfg, channels=None) -> tuple:
    """``(c0, c1, h0, h1)``: the run of channels ``[c0, c1)`` (all of
    them when ``channels`` is None) and the heads ``[h0, h1)`` it touches."""
    di = 2 * cfg.d_model
    p = di // cfg.num_heads
    c0, c1 = channels or (0, di)
    return c0, c1, c0 // p, -(-c1 // p)


def init_ssm_state(cfg, batch: int, dtype, lead, device="cpu", channels=None) -> SSMState:
    """Zero decode state for ``batch`` rows; ``lead`` are the axes before
    the rows (the chains, and a layer stack's ``L`` before them).
    ``channels`` (a rank's run, ``ModelAxis.ssm``): the state of its
    channels, ``h`` over the heads they touch."""
    c0, c1, h0, h1 = channel_heads(cfg, channels)
    n, K = cfg.ssm_state, cfg.ssm_conv
    p = 2 * cfg.d_model // cfg.num_heads
    lead = tuple(lead) + (batch,)
    return SSMState(
        h=torch.zeros(lead + (h1 - h0, p, n), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (K - 1, c1 - c0), dtype=dtype, device=device),
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

    def step(j: int, h):
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
        return y_intra + y_inter, h

    trips = S // c
    if xh.device.type == "meta" and trips > 1:  # counted once, times the trips
        y, h = repeated(trips, step, 0, h)
        return y[:, None].expand(N, trips, c, H, p).reshape(N, S, H, p), h
    ys = []
    for j in range(trips):
        y, h = step(j, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def apply_ssm(params, x, cfg, *, chunk: int = 64, state: SSMState | None = None,
              tp=None):
    """Full-sequence SSD block over a chain bank: x (C, B, S, d) -> (C, B,
    S, d).  With ``state`` (decode) S is 1, the recurrence is one step, and
    the result is ``(out, new state)``.  Under a model axis ``tp`` that
    splits the channels the rank computes its run (the module's header),
    and ``state`` is its channels'."""
    C, B, S, d = x.shape
    di = 2 * d
    p = di // cfg.num_heads
    split = tp is not None and tp.ssm is not None
    c0, c1, h0, h1 = channel_heads(cfg, tp.ssm if split else None)
    H = h1 - h0  # the heads the channels touch (all of them unsplit)
    ch = slice(c0, c1)
    decode = split and state is not None
    if split:
        # a decode step projects onto in_proj's block and gathers its few
        # rows' [x | z] columns; a sequence gathers in_proj instead, d rows
        # against its B·S
        params = tp.ssm_leaves(params, keep=("in_proj",) if decode else ())
        x = tp.copy_to(x)
    w_in = params["in_proj"]  # (C, d, 2 di): [x | z]
    if decode:
        y = tp.gather_columns(bank_matmul(x, w_in))
        xi, z = y[..., ch], y[..., di + c0:di + c1]
    else:
        if split:
            w_in = torch.cat([w_in[..., ch], w_in[..., di + c0:di + c1]], dim=-1)
        xi, z = bank_matmul(x, w_in).chunk(2, dim=-1)  # (C, B, S, di)
    xi, new_conv = _depthwise_conv(xi, params["conv_w"][..., ch], params["conv_b"][..., ch],
                                   None if state is None else state.conv)
    xi = F.silu(xi)
    bc = bank_matmul(xi, params["bc_proj"][..., ch, :])  # (C, B, S, 2n)
    dt = bank_matmul(xi, params["dt_w"][..., ch, :]).float()  # (C, B, S, H)
    if split:  # the ranks' partial products over their channels, summed once
        both = tp.all_sum(torch.cat([bc.float(), dt], dim=-1))
        bc, dt = both[..., :bc.shape[-1]].to(xi.dtype), both[..., bc.shape[-1]:]
    bt, ct = bc.chunk(2, dim=-1)
    dt = softplus(dt + per_chain(params["dt_bias"], xi))[..., h0:h1]
    a = -torch.exp(params["a_log"][:, h0:h1])  # (C, H), negative
    pad = (c0 - h0 * p, h1 * p - c1)  # a cut head's channels off the rank: zeros
    xh = (F.pad(xi, pad) if any(pad) else xi).reshape(C, B, S, H, p)

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

    y = y + params["d_skip"][:, None, None, h0:h1, None] * xh.float()
    y = y.reshape(C, B, S, H * p)[..., pad[0]:pad[0] + c1 - c0].to(x.dtype)
    norm = per_chain(params["norm"][..., ch], y)
    if split:
        y = tp.rms_norm(y * F.silu(z), norm, di, cfg.norm_eps)
        out = tp.reduce_from(bank_matmul(y, params["out_proj"]))  # row-parallel
    else:
        y = rms_norm(y * F.silu(z), norm, cfg.norm_eps)
        out = bank_matmul(y, params["out_proj"])
    if state is None:
        return out
    return out, new_state
