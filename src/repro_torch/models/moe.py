"""Mixture-of-Experts FFN over a chain bank (port of ``repro.models.moe``,
its ``mesh=None`` path).

Parameters carry the chain axis: the router ``(C, d, E)`` in float32, the
experts ``(C, E, d, f)`` / ``(C, E, f, d)`` and the shared experts ``(C, d,
f * n_shared)``; activations are ``(C, B, S, d)``.  Each chain routes its
own ``B * S`` tokens exactly as the reference's one-chain model does when
its engine ``vmap``s it over the bank:

- the router runs in float32 (``x.float() @ router``, softmax, top-k,
  renormalised); the top-k breaks ties by the lower expert index, as
  ``lax.top_k`` does (a stable descending sort, where ``torch.topk``'s tie
  order is unspecified);
- capacity comes from one chain's tokens, never the bank's: ``capacity(B *
  S)``;
- a (token, slot) pair's rank among its expert's pairs is a cumulative count
  over the pairs token-major, then slot; pairs whose rank reaches the
  capacity are dropped on the way in and read back as 0 (the reference's
  ``mode="drop"`` / ``mode="fill"``);
- the expert products are batched GEMMs over the ``(C, E, cap, d)`` capacity
  buffers, as the JAX package leaves them to XLA outside any kernel;
- a token's k contributions are added in slot order, in the activations'
  dtype, as the reference's scatter-add into zeros does (no atomics: the
  same bits on every call);
- the Switch load-balance loss is each chain's own, ``E * sum(frac_tokens *
  frac_probs)``, shape ``(C,)``.

The dropped pairs are counted on the device without a host sync (one
reduction a layer); :func:`dropped_pairs` reads the count and
:func:`reset_dropped` clears it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, bank_matmul, dense_init

CAPACITY_FACTOR = 1.25

_DROPPED: dict = {}  # device -> 0-d int64 tensor: pairs dropped since the reset


def init_moe(generator, cfg, dtype, lead=(), device="cpu") -> dict:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    params = {
        "router": dense_init(generator, lead + (d, E), torch.float32, device=device),
        "w_gate": dense_init(generator, lead + (E, d, f), dtype, device=device),
        "w_up": dense_init(generator, lead + (E, d, f), dtype, device=device),
        "w_down": dense_init(generator, lead + (E, f, d), dtype, device=device),
    }
    if cfg.num_shared_experts > 0:
        fs = f * cfg.num_shared_experts
        params["shared_w_gate"] = dense_init(generator, lead + (d, fs), dtype, device=device)
        params["shared_w_up"] = dense_init(generator, lead + (d, fs), dtype, device=device)
        params["shared_w_down"] = dense_init(generator, lead + (fs, d), dtype, device=device)
    return params


def capacity(tokens_local: int, cfg) -> int:
    """Pairs an expert takes from ``tokens_local`` tokens (one chain's)."""
    c = math.ceil(tokens_local * cfg.experts_per_token / cfg.num_experts
                  * CAPACITY_FACTOR)
    return max(4, min(c, tokens_local))


def dropped_pairs() -> int:
    """(token, expert) pairs dropped at capacity since :func:`reset_dropped`
    (a host sync)."""
    return int(sum(int(n.item()) for n in _DROPPED.values()))


def reset_dropped() -> None:
    _DROPPED.clear()


def _count_dropped(keep: torch.Tensor) -> None:
    if keep.device.type == "meta":  # no values to count (the dry run)
        return
    n = (~keep).sum()
    prev = _DROPPED.get(keep.device)
    _DROPPED[keep.device] = n if prev is None else prev + n


def route(params, xt, cfg):
    """The router, in float32: xt (C, T, d) -> (probs (C, T, E), weights
    (C, T, k) renormalised, experts (C, T, k)), each token's k experts in
    descending probability, ties to the lower index."""
    k = cfg.experts_per_token
    probs = torch.softmax(torch.bmm(xt.float(), params["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return probs, vals / vals.sum(dim=-1, keepdim=True), idx


def _moe_local(params, xt, cfg, cap: int, act):
    """Route, dispatch and compute every expert of each chain.

    xt: (C, T, d), each chain's T tokens; returns (out (C, T, d), aux (C,))."""
    C, T, d = xt.shape
    k, E = cfg.experts_per_token, cfg.num_experts

    probs, vals, idx = route(params, xt, cfg)
    flat_e = idx.reshape(C, T * k)
    seen = torch.cumsum(F.one_hot(flat_e, E).to(torch.int32), dim=1, dtype=torch.int32)
    rank = seen.gather(2, flat_e[..., None])[..., 0] - 1  # (C, T * k)
    keep = rank < cap
    _count_dropped(keep)
    # row e * cap + rank of the capacity buffers; dropped pairs go to a spare
    # last row, never read
    row = torch.where(keep, flat_e * cap + rank, E * cap)[..., None].expand(C, T * k, d)
    pairs = xt[:, :, None].expand(C, T, k, d).reshape(C, T * k, d)
    buf = xt.new_zeros(C, E * cap + 1, d).scatter(1, row, pairs)
    buf = buf[:, :E * cap].reshape(C, E, cap, d)

    h = act(torch.matmul(buf, params["w_gate"])) * torch.matmul(buf, params["w_up"])
    out_e = torch.matmul(h, params["w_down"]).reshape(C, E * cap, d)
    out_e = torch.cat([out_e, out_e.new_zeros(C, 1, d)], dim=1)  # dropped: 0
    back = out_e.gather(1, row).reshape(C, T, k, d)
    contrib = (vals[..., None] * back.float()).to(xt.dtype)
    out = torch.zeros_like(xt)
    for j in range(k):  # slot order, in xt's dtype
        out = out + contrib[:, :, j]

    # Switch-style load-balance aux, from the full router output
    frac_tokens = torch.zeros(C, E, device=xt.device).scatter_add_(
        1, flat_e, torch.ones(C, T * k, device=xt.device)) / (T * k)
    frac_probs = probs.mean(dim=1)
    aux = E * (frac_tokens * frac_probs).sum(dim=-1)
    return out, aux


def _shared_partial(params, xt, act):
    if "shared_w_gate" not in params:
        return 0.0
    h = act(bank_matmul(xt, params["shared_w_gate"])) * bank_matmul(
        xt, params["shared_w_up"])
    return bank_matmul(h, params["shared_w_down"])


def apply_moe(params, x, cfg):
    """x: (C, B, S, d) -> (y (C, B, S, d), aux (C,)).  Capacity from one
    chain's ``B * S`` tokens."""
    act = activation(cfg.act)
    C, B, S, d = x.shape
    xt = x.reshape(C, B * S, d)
    out, aux = _moe_local(params, xt, cfg, capacity(B * S, cfg), act)
    out = out + _shared_partial(params, xt, act)
    return out.reshape(C, B, S, d), aux
