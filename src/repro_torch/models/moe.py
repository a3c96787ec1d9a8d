"""Mixture-of-Experts FFN over a chain bank (port of ``repro.models.moe``).

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

Expert parallelism (``mesh=``, the reference's ``shard_map`` path): a rank
holds ``E / m`` experts of the ``model`` axis' ``m``, from ``rank * E / m``
on, and the router whole; it routes all its tokens, and ranks every pair
among its expert's pairs over all of them, so every rank of the axis drops
the same pairs; only the dispatch into its own experts' buffers runs per
rank.  Capacity comes from the rank's tokens (a batch split over
``batch_axes`` gives each rank ``B / data`` rows).  The shared experts are
column- and row-parallel where the specs split them.  ``out`` is summed
over ``model``; ``aux`` is averaged over ``model`` and the batch axes.  The
collectives are differentiable (:func:`~repro_torch.models.common.copy_to`
at the entry of the rank's part, ``reduce_from`` at its exit): a rank's
router gradient is its experts' part and its share of the aux, summed
over ``model`` by the gradient function; over a batch axis the aux's value
is the shards' mean and its gradient each shard's own, as the gradient is
averaged over the shards after the step.
Experts the axis does not divide are refused (the reference divides
without checking).  Under ``fsdp_tp`` a rank holds its experts' ``d_ff``
split over the data axes too (FSDP); the model gathers them whole for the
layer (``Model``'s layer gather, the reference's ``all_gather`` over
``fsdp_axes`` inside its ``shard_map``) before they reach
:func:`apply_moe`, which sees the rank's experts whole.

The dropped pairs are counted on the device without a host sync (one
reduction a layer); :func:`dropped_pairs` reads the count and
:func:`reset_dropped` clears it.  Under expert parallelism every rank
counts every pair its tokens drop (not only its experts'), the count an
unplaced run of the same tokens makes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_size
from repro_torch.models.common import (
    MODEL_AXIS,
    activation,
    bank_matmul,
    copy_to,
    dense_init,
    mean_value,
    reduce_from,
    replaying,
    split_keys,
)

CAPACITY_FACTOR = 1.25

_DROPPED: dict = {}  # device -> 0-d int64 tensor: pairs dropped since the reset


def init_moe(keys, cfg, dtype, device="cpu") -> dict:
    """The reference's ``init_moe`` under each key of ``keys`` (``lead +
    (2,)``): ``split(key, 7)``, the router in float32."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    lead = tuple(keys.shape[:-1])
    ks = split_keys(keys, 7)
    params = {
        "router": dense_init(ks[0], lead + (d, E), torch.float32, device=device),
        "w_gate": dense_init(ks[1], lead + (E, d, f), dtype, device=device),
        "w_up": dense_init(ks[2], lead + (E, d, f), dtype, device=device),
        "w_down": dense_init(ks[3], lead + (E, f, d), dtype, device=device),
    }
    if cfg.num_shared_experts > 0:
        fs = f * cfg.num_shared_experts
        params["shared_w_gate"] = dense_init(ks[4], lead + (d, fs), dtype, device=device)
        params["shared_w_up"] = dense_init(ks[5], lead + (d, fs), dtype, device=device)
        params["shared_w_down"] = dense_init(ks[6], lead + (fs, d), dtype, device=device)
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
    if keep.device.type == "meta" or replaying():  # no values / counted already
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


def _moe_local(params, xt, cfg, cap: int, act, e_offset: int = 0):
    """Route, dispatch and compute the experts ``params`` holds — ``e_local``
    of them from ``e_offset`` on (all of them by default) — for each chain.

    xt: (C, T, d), each chain's T tokens; returns (out (C, T, d), the sum of
    its experts' contributions, and aux (C,))."""
    C, T, d = xt.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    e_local = params["w_gate"].shape[-3]

    probs, vals, idx = route(params, xt, cfg)
    flat_e = idx.reshape(C, T * k)
    seen = torch.cumsum(F.one_hot(flat_e, E).to(torch.int32), dim=1, dtype=torch.int32)
    rank = seen.gather(2, flat_e[..., None])[..., 0] - 1  # (C, T * k)
    keep = rank < cap
    _count_dropped(keep)
    # row e * cap + rank of the capacity buffers, e the local expert; dropped
    # pairs and other ranks' experts' go to a spare last row, never read
    le = flat_e - e_offset
    mine = keep & (le >= 0) & (le < e_local)
    row = torch.where(mine, le * cap + rank, e_local * cap)[..., None].expand(C, T * k, d)
    pairs = xt[:, :, None].expand(C, T, k, d).reshape(C, T * k, d)
    buf = xt.new_zeros(C, e_local * cap + 1, d).scatter(1, row, pairs)
    buf = buf[:, :e_local * cap].reshape(C, e_local, cap, d)

    h = act(torch.matmul(buf, params["w_gate"])) * torch.matmul(buf, params["w_up"])
    out_e = torch.matmul(h, params["w_down"]).reshape(C, e_local * cap, d)
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


def apply_moe(params, x, cfg, mesh=None, batch_axes=()):
    """x: (C, B, S, d) -> (y (C, B, S, d), aux (C,)).  Capacity from one
    chain's ``B * S`` tokens.

    With ``mesh`` (a ``DeviceMesh`` with a ``model`` axis) the experts are
    parallel over ``model``: ``params`` holds the rank's ``E / m`` experts
    (and its shared-expert columns / rows where they are split), ``x`` the
    rank's rows (``B`` of them, the batch split over ``batch_axes``, or
    every rank's when ``batch_axes`` is empty); ``y`` is the rank's rows of
    the whole, every rank of the axis the same bits, ``aux`` averaged over
    ``model`` and ``batch_axes``."""
    act = activation(cfg.act)
    C, B, S, d = x.shape
    xt = x.reshape(C, B * S, d)
    if mesh is None:
        out, aux = _moe_local(params, xt, cfg, capacity(B * S, cfg), act)
        out = out + _shared_partial(params, xt, act)
        return out.reshape(C, B, S, d), aux
    m, E = axis_size(mesh, MODEL_AXIS), cfg.num_experts
    if E % m:
        raise ValueError(f"{cfg.name}: {E} experts do not divide over the "
                         f"{MODEL_AXIS!r} axis of size {m}")
    if params["w_gate"].shape[-3] != E // m:
        raise ValueError(f"expert parallelism takes the rank's {E // m} experts, got "
                         f"{params['w_gate'].shape[-3]}")
    r, group = mesh.get_local_rank(MODEL_AXIS), mesh.get_group(MODEL_AXIS)
    split = ("shared_w_gate" in params and params["shared_w_gate"].shape[-1] * m
             == cfg.d_ff * cfg.num_shared_experts)
    # the router, the rank's experts and its shared-expert columns compute
    # the rank's part: their input's gradient is summed over the axis
    xin = copy_to(xt, group) if m > 1 else xt
    out, aux = _moe_local(params, xin, cfg, capacity(B * S, cfg), act, r * (E // m))
    if split:  # a partial sum over the rank's columns, summed with the experts'
        out = out + _shared_partial(params, xin, act)
    if m > 1:
        out = reduce_from(out, group)
        aux = reduce_from(aux, group)
    if not split:
        out = out + _shared_partial(params, xt, act)
    for a in batch_axes:  # the value the mean over the shards, the gradient each's
        if axis_size(mesh, a) > 1:
            aux = mean_value(aux, mesh.get_group(a), axis_size(mesh, a), (a,))
    return out.reshape(C, B, S, d), aux / m if m > 1 else aux
