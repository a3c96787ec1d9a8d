"""The attention decoders (``attn_mlp``, ``attn_moe``) over a chain bank:
init, forward, prefill, and the two cached decode paths — port of
``repro.models.transformer``.

Parameters are the JAX package's nested dict: ``embed``, ``final_norm``,
``lm_head`` and a layer-stacked ``stack``.  The model functions take a
**chain bank**: every leaf has a leading chain axis ``(C, ...)`` (``stack``
leaves are ``(C, L, ...)``) and activations are ``(C, B, ...)``.  Where the
JAX engines ``vmap`` a one-chain model over the bank, the port writes the
chain axis out: projections are batched GEMMs over it, and each decode step
makes one kernel launch per layer that covers every chain.

Decode state is layer-major — ``(L, C, ...)`` — so that one layer's state
for all chains is one contiguous tensor the kernel updates in place.

Attention without a cache goes through :func:`~repro_torch.models.
attention.attention_any`, as the reference's does: naive up to 512 query
positions, the long-prompt SDPA path above.  The prefills unembed only the
position they return (one row of logits, not ``(C, B, S, V)``).

``attn_moe`` replaces the MLP by :mod:`~repro_torch.models.moe`; its
load-balance loss comes back from :meth:`Model.forward` per chain.  The
vision and audio frontends are the reference's stub: precomputed
``FRONTEND_DIM``-wide embeddings ``(B, N, 1024)`` in float32, projected by
``params["frontend"]["proj"]`` and prepended to the token embeddings.
SSM and xLSTM blocks (heterogeneous stacks, recurrent decode state) come
with a later slice.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.ops import fused_decode_step, fused_paged_decode_step
from repro_torch.models.attention import attention_any
from repro_torch.models.common import (
    apply_rope,
    bank_matmul,
    dense_init,
    dtype_of,
    embed_init,
    head_rms_norm,
    rms_norm,
)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.utils import resolve_device, to_device, tree_map

PyTree = Any

BLOCKS = ("attn_mlp", "attn_moe")  # the block kinds the port implements

FRONTEND_DIM = 1024  # stub embedding width (ViT / EnCodec feature dim)


# ===========================================================================
# init
# ===========================================================================
def _ones(shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def init_attn(generator, cfg, dtype, lead=(), device="cpu") -> dict:
    d = cfg.d_model
    lead = tuple(lead)
    p = {
        "wq": dense_init(generator, lead + (d, cfg.q_dim), dtype, device=device),
        "wk": dense_init(generator, lead + (d, cfg.kv_dim), dtype, device=device),
        "wv": dense_init(generator, lead + (d, cfg.kv_dim), dtype, device=device),
        "wo": dense_init(generator, lead + (cfg.q_dim, d), dtype,
                         scale=1.0 / math.sqrt(cfg.q_dim * 2 * cfg.num_layers),
                         device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = _ones(lead + (cfg.head_dim,), device)
        p["k_norm"] = _ones(lead + (cfg.head_dim,), device)
    return p


def init_block(generator, cfg, block: str, dtype, lead=(), device="cpu") -> dict:
    if block not in BLOCKS:
        raise ValueError(f"the port implements blocks {BLOCKS}, not {block!r}")
    lead = tuple(lead)
    p = {
        "norm1": _ones(lead + (cfg.d_model,), device),
        "attn": init_attn(generator, cfg, dtype, lead, device),
        "norm2": _ones(lead + (cfg.d_model,), device),
    }
    if block == "attn_moe":
        p["moe"] = init_moe(generator, cfg, dtype, lead, device)
    else:
        p["mlp"] = init_mlp(generator, cfg, dtype, lead, device)
    return p


def init_params(cfg, generator=None, *, device="cuda", num_chains=None) -> dict:
    """Random parameters in the JAX package's layout, drawn on ``device``
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    None).  ``num_chains`` adds the leading chain axis of a bank; ``None``
    gives one chain without it.  On the ``meta`` device nothing is drawn
    (shapes only — :meth:`ArchConfig.param_count` counts from that)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    if len(cfg.block_pattern) != 1:
        raise ValueError("the port implements homogeneous stacks "
                         f"(one block kind), got {cfg.block_pattern}")
    dtype = dtype_of(cfg)
    lead = () if num_chains is None else (int(num_chains),)
    params: dict = {
        "embed": {"w": embed_init(generator, lead + (cfg.vocab_size, cfg.d_model),
                                  dtype, device=dev)},
        "final_norm": _ones(lead + (cfg.d_model,), dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(
            generator, lead + (cfg.d_model, cfg.vocab_size), dtype, device=dev)}
    if cfg.frontend:
        params["frontend"] = {"proj": dense_init(
            generator, lead + (FRONTEND_DIM, cfg.d_model), dtype, device=dev)}
    params["stack"] = init_block(generator, cfg, cfg.block_pattern[0], dtype,
                                 lead + (cfg.num_layers,), dev)
    return params


# ===========================================================================
# block application (chain bank: params (C, ...), activations (C, B, ...))
# ===========================================================================
def _per_chain(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain vector ``(C, n)`` shaped to broadcast against ``like``
    ``(C, ..., n)``."""
    return w.reshape(w.shape[0], *([1] * (like.dim() - 2)), w.shape[-1])


def _qkv(p, x, cfg, positions):
    """Projections, qk-norm and rope: x (C, B, S, d) -> q (C, B, S, H, hd),
    k, v (C, B, S, KV, hd)."""
    C, B, S, _ = x.shape
    q = bank_matmul(x, p["wq"])
    k = bank_matmul(x, p["wk"])
    v = bank_matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + _per_chain(p["bq"], q)
        k = k + _per_chain(p["bk"], k)
        v = v + _per_chain(p["bv"], v)
    q = q.reshape(C, B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(C, B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(C, B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, _per_chain(p["q_norm"], q), cfg.norm_eps)
        k = head_rms_norm(k, _per_chain(p["k_norm"], k), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attn(p, x, cfg, positions, *, window, cache=None, cur_pos=None):
    """x: (C, B, S, d).  Without ``cache`` (prefill) returns (y, (k, v)).

    With ``cache`` — this layer's ``{"k", "v": (C, B, smax, KV, hd),
    "pos": (smax,)}`` — S is 1 and ``cur_pos`` the host-side absolute
    position: the decode step writes the new k/v row at ring slot
    ``cur_pos % smax`` **in place** and attends through
    :func:`~repro_torch.kernels.ops.fused_decode_step` (the CUDA kernel on a
    card).  Returns (y, cache)."""
    C, B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cache is None:  # prefill: chains flatten into the batch
        o = attention_any(q.reshape(C * B, S, H, hd), k.reshape(C * B, S, KV, hd),
                          v.reshape(C * B, S, KV, hd), causal=True, window=window)
        new_kv = (k, v)
    else:  # decode: S == 1
        smax = cache["k"].shape[2]
        slot = cur_pos % smax
        pos_arr = cache["pos"]
        pos_arr[slot] = cur_pos
        valid = (pos_arr >= 0) & (pos_arr <= cur_pos)
        if window is not None:
            valid &= pos_arr > (cur_pos - window)
        o, _, _ = fused_decode_step(
            q.reshape(C * B, H, hd), k.reshape(C * B, KV, hd),
            v.reshape(C * B, KV, hd), cache["k"].view(C * B, smax, KV, hd),
            cache["v"].view(C * B, smax, KV, hd), valid.to(torch.int32), slot)
        new_kv = cache
    y = bank_matmul(o.reshape(C, B, S, cfg.q_dim), p["wo"])
    return y, new_kv


def apply_paged_attn(p, x, cfg, pages, tables, positions):
    """Cached attention over a paged pool — one slot per row.

    x: (C, S, 1, d); pages: this layer's ``{"k", "v"}`` of
    ``(C, n_pages, page_size, KV, hd)``, one pool per chain, updated in
    place; tables: (S, maxp) int32; positions: (S,) int32 absolute position
    per slot (rope + write + validity).  Returns (y, pages)."""
    C, S, _, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions[:, None])
    o, _, _ = fused_paged_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                      pages["k"], pages["v"], tables, positions)
    y = bank_matmul(o.reshape(C, S, 1, cfg.q_dim), p["wo"])
    return y, pages


def _ffn(p, x, cfg, block: str):
    """The block's second half: returns (x, aux) with aux the MoE's
    load-balance loss per chain ``(C,)``, None for a dense block."""
    h2 = rms_norm(x, _per_chain(p["norm2"], x), cfg.norm_eps)
    if block == "attn_moe":
        ff, aux = apply_moe(p["moe"], h2, cfg)
    else:
        ff, aux = apply_mlp(p["mlp"], h2, cfg), None
    return x + cfg.residual_scale * ff, aux


def apply_paged_block(p, x, cfg, block: str, pages, tables, positions):
    """One decode step of an attention block against the paged pool: the
    residual/norm/MLP ops of :func:`apply_block` with
    :func:`apply_paged_attn` in place of the ring-cache attention."""
    if block not in BLOCKS:
        raise ValueError(f"paged decode needs an attention block, got {block!r}")
    h = rms_norm(x, _per_chain(p["norm1"], x), cfg.norm_eps)
    attn_out, pages = apply_paged_attn(p["attn"], h, cfg, pages, tables, positions)
    x = x + cfg.residual_scale * attn_out
    return _ffn(p, x, cfg, block)[0], pages


def apply_block(p, x, cfg, block: str, positions, *, cache=None, cur_pos=None):
    """Returns (x, aux_loss, new_cache) — ``aux_loss`` the MoE's ``(C,)``
    (None for a dense block), ``new_cache`` ``{"attn": ..}`` when decoding,
    else this layer's prefill (k, v)."""
    if block not in BLOCKS:
        raise ValueError(f"unknown block {block!r}")
    h = rms_norm(x, _per_chain(p["norm1"], x), cfg.norm_eps)
    attn_out, kv = apply_attn(p["attn"], h, cfg, positions,
                              window=cfg.sliding_window,
                              cache=None if cache is None else cache["attn"],
                              cur_pos=cur_pos)
    x = x + cfg.residual_scale * attn_out
    x, aux = _ffn(p, x, cfg, block)
    return x, aux, ({"attn": kv} if cache is not None else kv)


def _layer(stack: dict, i: int) -> dict:
    return tree_map(lambda a: a[:, i], stack)


# ===========================================================================
# the Model
# ===========================================================================
class Model:
    """Config-driven decoder over a chain bank on one device.

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` for the plain path.  Methods take the bank's params
    (leading chain axis) and return tensors on ``device``; token and
    position inputs may be numpy arrays or tensors."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _tokens(self, tokens) -> torch.Tensor:
        return to_device(tokens, self.device).long()

    # -- embedding ------------------------------------------------------------
    def embed(self, params, batch):
        """Returns (x (C, B, S, d), positions (S,)).  A frontend config's
        batch carries ``"frontend"`` stub embeddings ``(B, N, FRONTEND_DIM)``
        in float32: projected per chain, in float32 as JAX promotes ``fe @
        proj`` (proj upcast, fe kept), cast to the model's dtype and put
        before the tokens' embeddings."""
        parts = []
        if self.cfg.frontend:
            fe = to_device(batch["frontend"], self.device).float()
            proj = params["frontend"]["proj"]
            parts.append(bank_matmul(fe.expand(proj.shape[0], *fe.shape),
                                     proj.float()).to(dtype_of(self.cfg)))
        if "tokens" in batch:
            parts.append(params["embed"]["w"][:, self._tokens(batch["tokens"])])
        x = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
        return x, torch.arange(x.shape[2], device=self.device)

    def unembed(self, params, x):
        w = (params["embed"]["w"].transpose(-1, -2) if self.cfg.tie_embeddings
             else params["lm_head"]["w"])
        x = rms_norm(x, _per_chain(params["final_norm"], x), self.cfg.norm_eps)
        return bank_matmul(x, w)

    # -- forward over layers --------------------------------------------------
    def hidden(self, params, batch, want_kv: bool = False, layers=None):
        """The layers without the unembedding: returns (x (C, B, S, d), kv,
        aux) with kv ``(k, v)`` stacked ``(L, C, B, S, KV, hd)`` when
        ``want_kv``, else None, and aux each chain's load-balance loss
        summed over the layers, ``(C,)`` float32 (0 for dense blocks).
        ``layers`` (optional) gives each layer's parameters in place of the
        slices of ``params["stack"]``."""
        cfg = self.cfg
        x, positions = self.embed(params, batch)
        block = cfg.block_pattern[0]
        aux_total = torch.zeros(x.shape[0], device=self.device)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            layer = _layer(params["stack"], i) if layers is None else layers[i]
            x, aux, (k, v) = apply_block(layer, x, cfg, block, positions)
            if aux is not None:
                aux_total = aux_total + aux
            if want_kv:
                ks.append(k)
                vs.append(v)
        kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
        return x, kv, aux_total

    def forward(self, params, batch, want_kv: bool = False, layers=None):
        """Prefill / training forward.  Returns (logits (C, B, S, V), aux
        (C,), kv): aux each chain's ``aux_total / num_layers`` (the
        reference's per-chain value; 0 for dense blocks), kv ``(k, v)``
        stacked ``(L, C, B, S, KV, hd)`` when ``want_kv``.  ``layers``
        (optional) gives each layer's parameters in place of the slices of
        ``params["stack"]`` — the training path passes per-layer autograd
        leaves (:func:`repro_torch.train.loop.make_grad_fn`)."""
        x, kv, aux = self.hidden(params, batch, want_kv, layers)
        return self.unembed(params, x), aux / self.cfg.num_layers, kv

    def prefill(self, params, batch):
        """Full-prompt forward; returns (last-position logits (C, B, 1, V),
        cache), the reference's ``Model.prefill`` over the bank.

        The cache is ``{"attn": {"k", "v": (L, C, B, S, KV, hd), "pos":
        (S,) int32}}``, cut to the last ``sliding_window`` positions when the
        prompt is longer (every block the port implements is an attention
        block).  Only the last position is unembedded."""
        cfg = self.cfg
        x, (k, v), _ = self.hidden(params, batch, want_kv=True)
        logits = self.unembed(params, x[:, :, -1:])
        S, window = k.shape[3], cfg.sliding_window
        if window and S > window:
            k, v = k[:, :, :, -window:], v[:, :, :, -window:]
            pos = torch.arange(S - window, S, dtype=torch.int32, device=self.device)
        else:
            pos = torch.arange(S, dtype=torch.int32, device=self.device)
        return logits, {"attn": {"k": k, "v": v, "pos": pos}}

    # -- ring-cache decode ----------------------------------------------------
    def _require_stacked_attention(self, what: str):
        cfg = self.cfg
        if len(cfg.block_pattern) != 1 or cfg.block_pattern[0] not in BLOCKS:
            raise ValueError(f"{what} needs a homogeneous attention stack "
                             f"{BLOCKS}, got {cfg.block_pattern}")
        if cfg.frontend:
            raise ValueError(f"{what} serves token prompts only "
                             f"(frontend={cfg.frontend!r})")

    def init_cache_bank(self, num_chains: int, batch_size: int, max_seq: int,
                        prefill_len: int = 0):
        """Chain-bank decode cache: ``{"attn": {"k", "v": (L, C, B, smax,
        KV, hd), "pos": (L, smax)}}``.  ``pos`` holds each ring slot's
        absolute position (-1 empty); the chains share it, since they decode
        one token stream.  The engines' banks serve token prompts only: a
        frontend config is refused, as in the reference."""
        self._require_stacked_attention("init_cache_bank")
        return self._cache(num_chains, batch_size, max_seq, prefill_len)

    def init_cache(self, batch_size: int, max_seq: int, prefill_len: int = 0):
        """:meth:`init_cache_bank` for a bank of one chain, for every
        config the port runs — frontend configs too, as the reference's
        ``Model.init_cache`` (their stub positions are prefilled by the
        caller; decoding reads tokens only)."""
        return self._cache(1, batch_size, max_seq, prefill_len)

    def _cache(self, num_chains: int, batch_size: int, max_seq: int,
               prefill_len: int):
        cfg = self.cfg
        window = cfg.sliding_window
        smax = min(max_seq, window) if window else max_seq
        shape = (cfg.num_layers, num_chains, batch_size, smax,
                 cfg.num_kv_heads, cfg.head_dim)
        ar = torch.arange(smax, device=self.device, dtype=torch.int32)
        pos = torch.where(ar < prefill_len, ar, -1)
        return {"attn": {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=self.device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=self.device),
            "pos": pos[None].repeat(cfg.num_layers, 1),
        }}

    def prefill_cache(self, params, tokens, cache, prompt_len: int):
        """Padded-prompt prefill *into* the decode cache, in place.

        ``tokens`` is a bucket-padded ``(B, T_pad)`` prompt batch whose real
        length is ``prompt_len``; right-padding never leaks into real
        positions because attention is causal.  The prompt's KV lands in
        slots ``[0, T_pad)`` and slots at/after ``prompt_len`` are marked
        empty, so pad entries stay masked until the decode loop overwrites
        them.  Returns ``(logits at prompt_len - 1 (C, B, V), cache)``."""
        self._require_stacked_attention("prefill_cache")
        T = int(tokens.shape[1])
        smax = cache["attn"]["k"].shape[3]
        if T > smax:
            raise ValueError(
                f"padded prompt length {T} exceeds the cache's {smax} slots "
                "(raise max_seq, or loosen the prompt bucket ladder)")
        x, (k, v), _ = self.hidden(params, {"tokens": tokens}, want_kv=True)
        c = cache["attn"]
        c["k"][:, :, :, :T] = k
        c["v"][:, :, :, :T] = v
        ar = torch.arange(smax, device=self.device, dtype=torch.int32)
        c["pos"][:] = torch.where(ar < prompt_len, ar, -1)
        return self.unembed(params, x[:, :, prompt_len - 1]), cache

    def serve_step(self, params, cache, tokens, cur_pos: int):
        """One decode step, updating ``cache`` in place.  tokens: (B, 1);
        cur_pos: host int.  Returns (logits (C, B, 1, V), cache)."""
        cfg = self.cfg
        x = params["embed"]["w"][:, self._tokens(tokens)]  # (C, B, 1, d)
        positions = torch.tensor([cur_pos], device=self.device)
        c = cache["attn"]
        block = cfg.block_pattern[0]
        for i in range(cfg.num_layers):
            layer_cache = {"attn": {"k": c["k"][i], "v": c["v"][i],
                                    "pos": c["pos"][i]}}
            x, _, _ = apply_block(_layer(params["stack"], i), x, cfg, block,
                                  positions, cache=layer_cache, cur_pos=cur_pos)
        return self.unembed(params, x), cache

    # -- paged decode ---------------------------------------------------------
    def _require_paged(self, what: str):
        self._require_stacked_attention(what)
        if self.cfg.sliding_window:
            raise ValueError(
                f"{what} serves full attention only: a sliding window would "
                "need per-slot ring pages (the contiguous decode cache "
                "already implements windowed rings)")

    def init_paged_bank(self, num_chains: int, num_pages: int, page_size: int):
        """Paged decode-cache bank: one shared block pool per chain,
        ``{"k", "v"}`` of ``(L, C, num_pages, page_size, KV, hd)``.
        Physical page 0 is the garbage page inactive slots write into."""
        self._require_paged("init_paged_bank")
        cfg = self.cfg
        shape = (cfg.num_layers, num_chains, num_pages, page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=dtype_of(cfg), device=self.device)
                for n in ("k", "v")}

    def paged_prefill(self, params, tokens, pages, table, prompt_len: int):
        """Prefill one prompt into its slot's pages, in place.

        ``tokens`` is a bucket-padded ``(1, T_pad)`` prompt with true length
        ``prompt_len``; ``table`` is this slot's ``(maxp,)`` page table.
        The prompt's KV scatters into logical positions ``[0, T_pad)`` of
        the slot's pages (pad positions stay masked by the positional
        validity until overwritten).  Returns ``(logits at prompt_len - 1
        (C, 1, V), pages)``."""
        self._require_paged("paged_prefill")
        T = int(tokens.shape[1])
        L, C, n_pages, ps = pages["k"].shape[:4]
        table = torch.as_tensor(table, device=self.device).long()
        if T > table.shape[0] * ps:
            raise ValueError(
                f"padded prompt length {T} exceeds the slot's "
                f"{table.shape[0]} x {ps} paged capacity (raise max_seq, or "
                "loosen the prompt bucket ladder)")
        x, (k, v), _ = self.hidden(params, {"tokens": tokens}, want_kv=True)
        r = torch.arange(T, device=self.device)
        idx = table[r // ps] * ps + r % ps  # logical -> flat physical rows
        for name, new in (("k", k), ("v", v)):
            flat = pages[name].view(L, C, n_pages * ps, *pages[name].shape[4:])
            flat[:, :, idx] = new[:, :, 0]
        return self.unembed(params, x[:, :, prompt_len - 1]), pages

    def paged_step(self, params, pages, tables, tokens, positions):
        """One decode step over the serving slots of the paged pools.

        tokens: (S, 1); tables: (S, maxp) int32; positions: (S,) int32
        absolute position each slot's token is written at (the scheduler
        clamps inactive slots to 0 and points their table rows at the
        garbage page).  Returns (logits (C, S, 1, V), pages)."""
        self._require_paged("paged_step")
        cfg = self.cfg
        x = params["embed"]["w"][:, self._tokens(tokens)]  # (C, S, 1, d)
        tables = torch.as_tensor(tables, device=self.device).to(torch.int32)
        positions = torch.as_tensor(positions, device=self.device).to(torch.int32)
        block = cfg.block_pattern[0]
        for i in range(cfg.num_layers):
            layer_pages = {"k": pages["k"][i], "v": pages["v"][i]}
            x, _ = apply_paged_block(_layer(params["stack"], i), x, cfg, block,
                                     layer_pages, tables, positions)
        return self.unembed(params, x), pages


# ===========================================================================
# loss
# ===========================================================================
def loss_fn(model: Model, params, batch, layers=None):
    """Next-token cross-entropy plus the MoE aux, as
    ``repro.models.transformer.loss_fn``.

    ``batch["tokens"]`` is ``(B, S+1)`` (and a frontend config's batch
    carries ``"frontend"``); the model reads ``tokens[:, :-1]`` after the
    stub positions and is scored on ``tokens[:, 1:]`` at the text positions
    only, with a float32 log-softmax.  A chain's total is its mean CE plus
    ``router_aux_coef`` times its aux (0 for dense blocks); over a chain
    bank the loss is the sum of the chains' totals, so each chain's
    gradient is its own, and for a bank of one chain it is the reference's
    loss.  Returns ``(total, {"ce": ce, "aux": aux})``, 0-d tensors summed
    over the chains likewise."""
    tokens = model._tokens(batch["tokens"])
    logits, aux, _ = model.forward(params, {**batch, "tokens": tokens[:, :-1]},
                                   layers=layers)
    labels = tokens[:, 1:]
    logits = logits[:, :, -labels.shape[1]:]  # skip the frontend positions
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.expand(logits.shape[0], *labels.shape)
                      [..., None])[..., 0]
    ce = -ll.mean(dim=(-2, -1))
    total = (ce + model.cfg.router_aux_coef * aux).sum()
    return total, {"ce": ce.sum().detach(), "aux": aux.sum().detach()}
