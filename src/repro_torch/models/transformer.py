"""The decoders of every config over a chain bank: init, forward, prefill,
and the cached decode paths — port of ``repro.models.transformer``.

Block kinds (``cfg.block_pattern``, cycled over the layers):

- ``attn_mlp``   dense decoder layer (qk-norm / qkv-bias / sliding window
                 per config);
- ``attn_moe``   the MLP replaced by :mod:`~repro_torch.models.moe`;
- ``hymba_mlp``  attention and SSD heads (:mod:`~repro_torch.models.ssm`)
                 in parallel on the same input, mixed ``0.5 * (attn +
                 ssm)``, then the MLP;
- ``mlstm`` / ``slstm``  xLSTM blocks (:mod:`~repro_torch.models.xlstm`),
                 no separate MLP.

Parameters are the JAX package's nested dict: ``embed``, ``final_norm``,
``lm_head`` and either a layer-stacked ``stack`` (one block kind) or a
``layers`` list of per-layer dicts (a heterogeneous pattern: xLSTM).  The
model functions take a **chain bank**: every leaf has a leading chain axis
``(C, ...)`` (``stack`` leaves are ``(C, L, ...)``) and activations are
``(C, B, ...)``.  Where the JAX engines ``vmap`` a one-chain model over the
bank, the port writes the chain axis out: projections are batched GEMMs
over it, and each decode step makes one kernel launch per attention layer
that covers every chain.

Decode state is layer-major for a stack — ``(L, C, ...)`` — so that one
layer's state for all chains is one contiguous tensor the step updates in
place: the ring K/V, and hymba's SSD state (``ssm_h``, ``ssm_conv``).  An
xLSTM stack's decode state is a list of per-layer dicts, as in the
reference.  The recurrent stacks have no prefill-fillable cache: they are
served by :meth:`Model.init_cache` and one :meth:`Model.serve_step` a
prompt token (replay), as the reference serves them.

Attention without a cache goes through :func:`~repro_torch.models.
attention.attention_any`, as the reference's does: naive up to 512 query
positions, the long-prompt SDPA path above.  The prefills unembed only the
position they return (one row of logits, not ``(C, B, S, V)``).

``Model(cfg, mesh=...)`` splits each chain's tensors over the mesh's
``model`` axis, as :class:`~repro_torch.models.common.ModelAxis` lays them
out (the reference's ``Model(cfg, mesh=...)`` under GSPMD; the engines'
2-D banks): the model functions take a rank's local tensors; a rank
computes its query heads over its KV heads (its shard, or the slice of a
replicated K/V projection its queries read), its MLP columns, its experts
and its slice of the vocabulary; the row-parallel products and the
embedding's masked lookup are all-reduced over ``model``, and the logits
come back as the rank's vocabulary slice (:meth:`Model.gather_vocab`
gathers them).  The decode caches hold the local KV heads.  Under FSDP
(``fsdp_full``: every weight split over every axis; ``fsdp_tp``: the
experts' ``d_ff`` over the data axes) a rank holds its block of each such
leaf, and the model gathers it whole where it is used: the embedding and
the head as they are reached, a layer's leaves as the layer runs — under
``torch.utils.checkpoint`` when a gradient is taken, so a layer's gathered
weights are freed with its forward and gathered again for its backward
(ZeRO-3's gather a layer).  The
collectives are differentiable (Megatron-LM's mappings,
:func:`~repro_torch.models.common.copy_to` and its neighbours) and
:func:`loss_fn`'s cross-entropy is vocabulary-parallel, so a placed
model trains: :func:`repro_torch.launch.steps.make_sgld_train_step`.

``attn_moe``'s load-balance loss comes back from :meth:`Model.forward` per
chain.  The vision and audio frontends are the reference's stub:
precomputed ``FRONTEND_DIM``-wide embeddings ``(B, N, 1024)`` in float32,
projected by ``params["frontend"]["proj"]`` and prepended to the token
embeddings.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.analysis.cost import repeated
from repro_torch.kernels.ops import fused_decode_step, fused_paged_decode_step
from repro_torch.models.attention import attention_any
from repro_torch.models.common import (
    MODEL_AXIS,
    all_reduce,
    apply_rope,
    bank_matmul,
    dense_init,
    dtype_of,
    embed_init,
    head_rms_norm,
    ModelAxis,
    per_chain,
    replay,
    rms_norm,
)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.ssm import SSMState, apply_ssm, init_ssm, init_ssm_state
from repro_torch.models.xlstm import (
    MLSTMState,
    SLSTMState,
    apply_mlstm,
    apply_slstm,
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
)
from repro_torch.utils import resolve_device, to_device, tree_map

PyTree = Any

BLOCKS = ("attn_mlp", "attn_moe", "hymba_mlp", "mlstm", "slstm")
WITH_ATTN = ("attn_mlp", "attn_moe", "hymba_mlp")  # blocks with an attention half
ATTN_STACKS = ("attn_mlp", "attn_moe")  # the engines' stacks: a prefill-fillable cache

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
    p = {"norm1": _ones(lead + (cfg.d_model,), device)}
    if block in WITH_ATTN:
        p["attn"] = init_attn(generator, cfg, dtype, lead, device)
        p["norm2"] = _ones(lead + (cfg.d_model,), device)
    if block == "hymba_mlp":
        p["ssm"] = init_ssm(generator, cfg, dtype, lead, device)
    if block in ("attn_mlp", "hymba_mlp"):
        p["mlp"] = init_mlp(generator, cfg, dtype, lead, device)
    if block == "attn_moe":
        p["moe"] = init_moe(generator, cfg, dtype, lead, device)
    if block == "mlstm":
        p["mlstm"] = init_mlstm(generator, cfg, dtype, lead, device)
    if block == "slstm":
        p["slstm"] = init_slstm(generator, cfg, dtype, lead, device)
    return p


def init_params(cfg, generator=None, *, device="cuda", num_chains=None) -> dict:
    """Random parameters in the JAX package's layout, drawn on ``device``
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    None).  ``num_chains`` adds the leading chain axis of a bank; ``None``
    gives one chain without it.  On the ``meta`` device nothing is drawn
    (shapes only — :meth:`ArchConfig.param_count` counts from that).  One
    block kind gives a layer-stacked ``stack``; a heterogeneous pattern a
    ``layers`` list, layer i of kind ``block_pattern[i % len]``."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
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
    pattern = cfg.block_pattern
    if len(pattern) == 1:
        params["stack"] = init_block(generator, cfg, pattern[0], dtype,
                                     lead + (cfg.num_layers,), dev)
    else:
        params["layers"] = [init_block(generator, cfg, pattern[i % len(pattern)],
                                       dtype, lead, dev)
                            for i in range(cfg.num_layers)]
    return params


# ===========================================================================
# block application (chain bank: params (C, ...), activations (C, B, ...))
# ===========================================================================
def _heads(cfg, tp) -> tuple:
    """``(H, KV)``: the query and KV heads a rank computes (all of them
    without a model axis)."""
    return tp.heads[:2] if tp is not None else (cfg.num_heads, cfg.num_kv_heads)


def _qkv(p, x, cfg, positions, tp=None):
    """Projections, qk-norm and rope: x (C, B, S, d) -> q (C, B, S, H, hd),
    k, v (C, B, S, KV, hd), the rank's heads under a model axis ``tp`` (from
    a replicated K/V projection, the columns of the KV heads its queries
    read)."""
    C, B, S, _ = x.shape
    H, KV = _heads(cfg, tp)
    hd = cfg.head_dim
    if tp is not None and tp.attn:  # a column-parallel region: the rank's heads
        x = tp.copy_to(x)
    kv = {n: p.get(n) for n in ("wk", "wv", "bk", "bv")}
    if tp is not None and tp.kv_take:
        cols = slice(tp.heads[3] * hd, (tp.heads[3] + KV) * hd)
        kv = {n: None if t is None else t[..., cols] for n, t in kv.items()}
    q = bank_matmul(x, p["wq"])
    k = bank_matmul(x, kv["wk"])
    v = bank_matmul(x, kv["wv"])
    if cfg.qkv_bias:
        q = q + per_chain(p["bq"], q)
        k = k + per_chain(kv["bk"], k)
        v = v + per_chain(kv["bv"], v)
    q = q.reshape(C, B, S, H, hd)
    k = k.reshape(C, B, S, KV, hd)
    v = v.reshape(C, B, S, KV, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, per_chain(p["q_norm"], q), cfg.norm_eps)
        k = head_rms_norm(k, per_chain(p["k_norm"], k), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, o, tp):
    """``o @ wo``: under a model axis that splits the query heads, a
    partial sum over the rank's heads, summed over the axis."""
    y = bank_matmul(o, p["wo"])
    return tp.reduce_from(y) if tp is not None and tp.attn else y


def apply_attn(p, x, cfg, positions, *, window, cache=None, cur_pos=None, tp=None):
    """x: (C, B, S, d).  Without ``cache`` (prefill) returns (y, (k, v)).

    With ``cache`` — this layer's ``{"k", "v": (C, B, smax, KV, hd),
    "pos": (smax,)}`` — S is 1 and ``cur_pos`` the host-side absolute
    position: the decode step writes the new k/v row at ring slot
    ``cur_pos % smax`` **in place** and attends through
    :func:`~repro_torch.kernels.ops.fused_decode_step` (the CUDA kernel on a
    card).  Returns (y, cache).  Under a model axis ``tp`` the heads, k/v
    and the cache are the rank's."""
    C, B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, tp)
    (H, KV), hd = _heads(cfg, tp), cfg.head_dim
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
    return _out_proj(p, o.reshape(C, B, S, H * hd), tp), new_kv


def apply_paged_attn(p, x, cfg, pages, tables, positions, tp=None):
    """Cached attention over a paged pool — one slot per row.

    x: (C, S, 1, d); pages: this layer's ``{"k", "v"}`` of
    ``(C, n_pages, page_size, KV, hd)``, one pool per chain, updated in
    place; tables: (S, maxp) int32; positions: (S,) int32 absolute position
    per slot (rope + write + validity).  Returns (y, pages)."""
    C, S, _, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions[:, None], tp)
    o, _, _ = fused_paged_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                      pages["k"], pages["v"], tables, positions)
    return _out_proj(p, o.reshape(C, S, 1, -1), tp), pages


def _ffn(p, x, cfg, block: str, tp=None):
    """The block's second half: returns (x, aux) with aux the MoE's
    load-balance loss per chain ``(C,)``, None for a dense block."""
    h2 = rms_norm(x, per_chain(p["norm2"], x), cfg.norm_eps)
    if block == "attn_moe":
        ff, aux = apply_moe(p["moe"], h2, cfg, mesh=None if tp is None else tp.mesh,
                            batch_axes=() if tp is None else tp.batch_axes)
    else:
        ff, aux = apply_mlp(p["mlp"], h2, cfg, tp), None
    return x + cfg.residual_scale * ff, aux


def apply_paged_block(p, x, cfg, block: str, pages, tables, positions, tp=None):
    """One decode step of an attention block against the paged pool: the
    residual/norm/MLP ops of :func:`apply_block` with
    :func:`apply_paged_attn` in place of the ring-cache attention."""
    if block not in ATTN_STACKS:
        raise ValueError(f"paged decode needs an attention block, got {block!r}")
    h = rms_norm(x, per_chain(p["norm1"], x), cfg.norm_eps)
    attn_out, pages = apply_paged_attn(p["attn"], h, cfg, pages, tables, positions, tp)
    x = x + cfg.residual_scale * attn_out
    return _ffn(p, x, cfg, block, tp)[0], pages


def apply_block(p, x, cfg, block: str, positions, *, cache=None, cur_pos=None,
                tp=None):
    """Returns (x, aux_loss, new_cache) — ``aux_loss`` the MoE's ``(C,)``
    (None for other blocks); ``new_cache`` this layer's decode state
    (updated in place) when decoding, else the attention's prefill (k, v)
    (None for an xLSTM block)."""
    if block not in BLOCKS:
        raise ValueError(f"unknown block {block!r}")
    h = rms_norm(x, per_chain(p["norm1"], x), cfg.norm_eps)
    if block in ("mlstm", "slstm"):
        apply, state_cls = ((apply_mlstm, MLSTMState) if block == "mlstm"
                            else (apply_slstm, SLSTMState))
        if cache is None:
            return x + cfg.residual_scale * apply(p[block], h, cfg), None, None
        names = [f"{block}_{f}" for f in state_cls._fields]
        out, new = apply(p[block], h, cfg,
                         state=state_cls(*(cache[n] for n in names)))
        for n, t in zip(names, new):
            cache[n].copy_(t)
        return x + cfg.residual_scale * out, None, cache
    attn_out, kv = apply_attn(p["attn"], h, cfg, positions,
                              window=cfg.sliding_window,
                              cache=None if cache is None else cache["attn"],
                              cur_pos=cur_pos, tp=tp)
    if block == "hymba_mlp":
        if cache is None:
            ssm_out = apply_ssm(p["ssm"], h, cfg, tp=tp)
        else:
            ssm_out, new = apply_ssm(p["ssm"], h, cfg, state=SSMState(
                cache["ssm_h"], cache["ssm_conv"]), tp=tp)
            cache["ssm_h"].copy_(new.h)
            cache["ssm_conv"].copy_(new.conv)
        attn_out = 0.5 * (attn_out + ssm_out)
    x = x + cfg.residual_scale * attn_out
    x, aux = _ffn(p, x, cfg, block, tp)
    return x, aux, (cache if cache is not None else kv)


def _layer(stack: dict, i: int) -> dict:
    return tree_map(lambda a: a[:, i], stack)


def _block(cfg, i: int) -> str:
    return cfg.block_pattern[i % len(cfg.block_pattern)]


def _layer_cache(cache, i: int) -> dict:
    """Layer i's decode state: views of a stack's layer-major tensors, or
    the i-th dict of an xLSTM list (written in place either way)."""
    if isinstance(cache, list):
        return cache[i]
    out = {name: t[i] for name, t in cache.items() if name != "attn"}
    if "attn" in cache:
        out["attn"] = {name: t[i] for name, t in cache["attn"].items()}
    return out


# ===========================================================================
# the Model
# ===========================================================================
class Model:
    """Config-driven decoder over a chain bank on one device.

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` for the plain path.  Methods take the bank's params
    (leading chain axis) and return tensors on ``device``; token and
    position inputs may be numpy arrays or tensors.

    ``mesh`` (a ``DeviceMesh`` with a ``model`` axis; every config) makes
    the model tensor- and expert-parallel over that axis, as :attr:`tp` (a
    :class:`~repro_torch.models.common.ModelAxis`) lays it out: the methods
    take the rank's local tensors (a 2-D bank's
    :func:`~repro_torch.utils.local` block), every rank of the axis calls
    them with the same inputs, and the logits they return are the rank's
    vocabulary slice where the head is split (:meth:`gather_vocab`).
    hymba's SSD heads are split by channel (:mod:`~repro_torch.models.
    ssm`), an xLSTM block is computed whole on every rank (its leaves are
    replicated, as the reference lays them out), and a frontend's
    projection is column-parallel, its output gathered before it is put
    in front of the tokens.

    ``batch_axes`` (the reference's; with ``mesh`` only, empty by default,
    as a 2-D serving bank's other axis holds chains) are the mesh axes a
    training batch is split over: the methods take the rank's rows, the
    MoE's capacity is a shard's and its aux the mean over the shards
    (:func:`repro_torch.train.loop.make_grad_fn` averages the gradient
    over them).  The model's collectives are differentiable, so
    :func:`loss_fn` backpropagates to every rank's block.

    ``chain_axis`` (with ``mesh``): the axis a 2-D serving bank holds its
    chains on, whose spec entries the bank replicates (an ``fsdp_tp``
    config's experts stay whole there).  A ``fsdp_full`` config
    (``launch.steps.adapt_config(..., ("fsdp",))``) is gathered leaf by
    leaf.  The engines' banks (:meth:`init_cache_bank`, the paged pool)
    stay refused for the recurrent stacks and the frontend configs, placed
    or not, as the reference's engines refuse them; :meth:`init_cache`
    and :meth:`serve_step` serve them (replay)."""

    def __init__(self, cfg, device="cuda", mesh=None, batch_axes=(), chain_axis=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tp = None
        self.batch_axes = tuple(batch_axes)
        if mesh is None and self.batch_axes:
            raise ValueError(f"batch_axes {self.batch_axes} split a batch over a mesh: "
                             "pass mesh=")
        if mesh is not None:
            self.tp = ModelAxis.of(mesh, cfg, self.batch_axes, chain_axis)

    def _tokens(self, tokens) -> torch.Tensor:
        return to_device(tokens, self.device).long()

    # -- FSDP: a rank's blocks gathered where they are used --------------------
    def _top(self, params, name: str):
        """``params[name]`` (the embedding, the head, the frontend's
        projection) whole: its FSDP blocks gathered."""
        tp = self.tp
        if tp is None or not tp.fsdp:
            return params[name]
        return tp.gather(params[name], tp.gathers[name])

    def _gather_layer(self, i: int, layer: dict) -> dict:
        tp = self.tp
        if tp is None or not tp.fsdp:
            return layer
        if "stack" in tp.gathers:
            return tp.gather(layer, tp.gathers["stack"], skip=1)
        return tp.gather(layer, tp.gathers["layers"][i])

    def _run_layer(self, i: int, block: str, layer: dict, x, positions):
        """:func:`apply_block` of layer ``i``.  Under FSDP its leaves are
        gathered for it, inside a checkpoint when a gradient is taken: the
        gathered weights are freed with the layer's forward and gathered
        again when its backward recomputes it (under :func:`~repro_torch.
        models.common.replay`, so once-a-step counts are not taken twice)."""
        tp = self.tp
        if tp is None or not tp.fsdp:
            return apply_block(layer, x, self.cfg, block, positions, tp=tp)
        calls: list = []

        def body(x):
            with replay(len(calls) > 0):
                calls.append(1)
                return apply_block(self._gather_layer(i, layer), x, self.cfg, block,
                                   positions, tp=tp)

        if not torch.is_grad_enabled():
            return body(x)
        from torch.utils.checkpoint import checkpoint

        return checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)

    def _lookup(self, w, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``: ``w[:, tokens]`` per chain.
        With the vocabulary split over the model axis, a masked lookup of
        the rank's rows (zeros elsewhere) summed over the axis: exactly one
        rank adds a row, the others zeros, so the sum is the row's bits."""
        tokens = self._tokens(tokens)
        tp = self.tp
        if tp is None or not tp.vocab_in:
            return w[:, tokens]
        n = w.shape[1]
        t = tokens - tp.rank * n
        inside = (t >= 0) & (t < n)
        x = torch.where(inside[..., None], w[:, t.clamp(0, n - 1)], 0)
        return tp.reduce_from(x)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits ``(..., V)`` of every token from a rank's vocabulary slice
        (the axis' slices gathered in rank order); the logits themselves
        where the head is whole."""
        tp = self.tp
        if tp is None or not tp.vocab_out:
            return logits
        return tp.all_gather(logits, logits.dim() - 1)

    # -- embedding ------------------------------------------------------------
    def embed(self, params, batch):
        """Returns (x (C, B, S, d), positions (S,)).  A frontend config's
        batch carries ``"frontend"`` stub embeddings ``(B, N, FRONTEND_DIM)``
        in float32: projected per chain, in float32 as JAX promotes ``fe @
        proj`` (proj upcast, fe kept), cast to the model's dtype and put
        before the tokens' embeddings.  Where the model axis splits the
        projection's columns, each rank projects onto its columns and the
        ranks' columns are gathered (column-parallel)."""
        parts = []
        if self.cfg.frontend:
            fe = to_device(batch["frontend"], self.device).float()
            proj = self._top(params, "frontend")["proj"]
            y = bank_matmul(fe.expand(proj.shape[0], *fe.shape),
                            proj.float()).to(dtype_of(self.cfg))
            if self.tp is not None and proj.shape[-1] < self.cfg.d_model:
                y = self.tp.all_gather(y, y.dim() - 1)
            parts.append(y)
        if "tokens" in batch:
            parts.append(self._lookup(self._top(params, "embed")["w"], batch["tokens"]))
        x = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
        return x, torch.arange(x.shape[2], device=self.device)

    def unembed(self, params, x):
        w = (self._top(params, "embed")["w"].transpose(-1, -2) if self.cfg.tie_embeddings
             else self._top(params, "lm_head")["w"])
        x = rms_norm(x, per_chain(params["final_norm"], x), self.cfg.norm_eps)
        if self.tp is not None and self.tp.vocab_out:  # the rank's vocabulary columns
            x = self.tp.copy_to(x)
        return bank_matmul(x, w)

    # -- forward over layers --------------------------------------------------
    def _layers(self, params, layers=None):
        """(block kind, layer parameters) for each layer: ``layers[i]`` when
        given, else the slice of ``params["stack"]`` or ``params["layers"][i]``."""
        for i in range(self.cfg.num_layers):
            if layers is not None:
                layer = layers[i]
            elif "stack" in params:
                layer = _layer(params["stack"], i)
            else:
                layer = params["layers"][i]
            yield _block(self.cfg, i), layer

    def hidden(self, params, batch, want_kv: bool = False, layers=None, tap=None):
        """The layers without the unembedding: returns (x (C, B, S, d), kv,
        aux) with kv ``(k, v)`` stacked ``(L, C, B, S, KV, hd)`` when
        ``want_kv`` (an attention stack's), else None, and aux each chain's
        load-balance loss summed over the layers, ``(C,)`` float32 (0 for
        blocks without a router).  ``layers`` (optional) gives each layer's
        parameters in place of ``params["stack"]`` / ``params["layers"]``.
        ``tap`` (optional), as :meth:`serve_step`'s."""
        x, positions = self.embed(params, batch)
        aux_total = torch.zeros(x.shape[0], device=self.device)
        ks, vs = [], []
        steps = list(self._layers(params, layers))
        period = len(self.cfg.block_pattern)
        if x.device.type == "meta" and tap is None and len(steps) > period \
                and len(steps) % period == 0:
            # every period of the block pattern is alike: on meta (the dry
            # run) one period, counted num_layers / period times
            def one_period(x):
                aux_p, kvs = torch.zeros_like(aux_total), []
                for i, (block, layer) in enumerate(steps[:period]):
                    x, aux, kv = self._run_layer(i, block, layer, x, positions)
                    aux_p = aux_p if aux is None else aux_p + aux
                    kvs.append(kv)
                return x, aux_p, kvs

            x, aux, kvs = repeated(len(steps) // period, one_period, x)
            aux_total = aux_total + aux
            if want_kv:
                ks = [kv[0] for kv in kvs] * (len(steps) // period)
                vs = [kv[1] for kv in kvs] * (len(steps) // period)
            steps = []
        for i, (block, layer) in enumerate(steps):
            if tap is not None:
                x = tap(i, x)
            x, aux, kv = self._run_layer(i, block, layer, x, positions)
            if aux is not None:
                aux_total = aux_total + aux
            if want_kv:
                ks.append(kv[0])
                vs.append(kv[1])
        if tap is not None:
            x = tap(self.cfg.num_layers, x)
        kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
        return x, kv, aux_total

    def forward(self, params, batch, want_kv: bool = False, layers=None):
        """Prefill / training forward.  Returns (logits (C, B, S, V), aux
        (C,), kv): aux each chain's ``aux_total / num_layers`` (the
        reference's per-chain value; 0 for dense blocks), kv ``(k, v)``
        stacked ``(L, C, B, S, KV, hd)`` when ``want_kv``.  ``layers``
        (optional) gives each layer's parameters in place of
        ``params["stack"]`` / ``params["layers"]`` — the training path
        passes per-layer autograd leaves
        (:func:`repro_torch.train.loop.make_grad_fn`)."""
        x, kv, aux = self.hidden(params, batch, want_kv, layers)
        return self.unembed(params, x), aux / self.cfg.num_layers, kv

    def prefill(self, params, batch):
        """Full-prompt forward; returns (last-position logits (C, B, 1, V),
        cache), the reference's ``Model.prefill`` over the bank.

        For an attention stack the cache is ``{"attn": {"k", "v": (L, C, B,
        S, KV, hd), "pos": (S,) int32}}``, cut to the last
        ``sliding_window`` positions when the prompt is longer.  The
        recurrent stacks (hymba, xLSTM) return None: their state is rebuilt
        by replaying the prompt through :meth:`serve_step` from
        :meth:`init_cache`, as in the reference.  Only the last position is
        unembedded."""
        cfg = self.cfg
        if not self._attention_stack():
            x, _, _ = self.hidden(params, batch)
            return self.unembed(params, x[:, :, -1:]), None
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
    def _attention_stack(self) -> bool:
        pattern = self.cfg.block_pattern
        return len(pattern) == 1 and pattern[0] in ATTN_STACKS

    def _require_stacked_attention(self, what: str):
        cfg = self.cfg
        if not self._attention_stack():
            raise ValueError(
                f"{what} needs a homogeneous attention stack "
                f"(block_pattern ('attn_mlp',) or ('attn_moe',)), got "
                f"{cfg.block_pattern}; SSM/xLSTM states have no prefill-"
                "fillable KV cache")
        if cfg.frontend:
            raise ValueError(f"{what} serves token prompts only "
                             f"(frontend={cfg.frontend!r})")

    def init_cache_bank(self, num_chains: int, batch_size: int, max_seq: int,
                        prefill_len: int = 0):
        """The engines' chain-bank decode cache: :meth:`init_cache` of
        ``num_chains`` chains, ``{"attn": {"k", "v": (L, C, B, smax, KV,
        hd), "pos": (L, smax)}}``.  ``pos`` holds each ring slot's absolute
        position (-1 empty); the chains share it, since they decode one
        token stream.  The engines serve homogeneous attention stacks of
        token prompts only: the recurrent stacks and the frontend configs
        are refused, as in the reference."""
        self._require_stacked_attention("init_cache_bank")
        return self.init_cache(batch_size, max_seq, prefill_len, num_chains)

    def init_cache(self, batch_size: int, max_seq: int, prefill_len: int = 0,
                   num_chains: int = 1):
        """The decode cache of every config the port runs — frontend
        configs too, as the reference's ``Model.init_cache`` (their stub
        positions are prefilled by the caller; decoding reads tokens only),
        and the recurrent stacks, served by replay — for a bank of
        ``num_chains`` chains (one by default).

        A stack's cache is layer-major: an attention block's ring
        ``{"attn": ...}`` as :meth:`init_cache_bank` gives it, and hymba's
        SSD state beside it, ``ssm_h`` ``(L, C, B, H, p, n)`` float32 and
        ``ssm_conv`` ``(L, C, B, K-1, di)`` in the model's dtype.  Under a
        model axis the ring holds the rank's KV heads, and the SSD state
        its run of channels (``ssm_h`` over the heads they touch).  An xLSTM
        stack's is a list of per-layer dicts: ``mlstm_{c,n,m}`` ``(C, B, H,
        dk, dk)``, ``(C, B, H, dk)``, ``(C, B, H)``, or ``slstm_{c,n,m,h}``
        ``(C, B, d)``, float32.  :meth:`init_cache_bank` is this cache
        behind the engines' refusal of the stacks they cannot serve."""
        cfg = self.cfg
        L, lead = cfg.num_layers, (num_chains,)
        if len(cfg.block_pattern) > 1:
            return [self._recurrent_state(_block(cfg, i), lead, batch_size)
                    for i in range(L)]
        window = cfg.sliding_window
        smax = min(max_seq, window) if window else max_seq
        shape = (L, num_chains, batch_size, smax, _heads(cfg, self.tp)[1], cfg.head_dim)
        ar = torch.arange(smax, device=self.device, dtype=torch.int32)
        pos = torch.where(ar < prefill_len, ar, -1)
        cache = {"attn": {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=self.device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=self.device),
            "pos": pos[None].repeat(L, 1),
        }}
        if cfg.block_pattern[0] == "hymba_mlp":
            cache.update(self._recurrent_state("hymba_mlp", (L,) + lead, batch_size))
        return cache

    def _recurrent_state(self, block: str, lead, batch_size: int) -> dict:
        cfg, dev = self.cfg, self.device
        if block == "hymba_mlp":
            st = init_ssm_state(cfg, batch_size, dtype_of(cfg), lead, dev,
                                channels=None if self.tp is None else self.tp.ssm)
            return {"ssm_h": st.h, "ssm_conv": st.conv}
        if block == "mlstm":
            st = init_mlstm_state(cfg, batch_size, lead, dev)
        else:
            st = init_slstm_state(cfg, batch_size, lead, dev)
        return {f"{block}_{f}": t for f, t in zip(st._fields, st)}

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

    def serve_step(self, params, cache, tokens, cur_pos: int, tap=None):
        """One decode step, updating ``cache`` (from :meth:`init_cache` or a
        prefill) in place.  tokens: (B, 1); cur_pos: host int.  Returns
        (logits (C, B, 1, V), cache).

        ``tap`` (optional), ``tap(i, x) -> x``, sees the input to layer i
        (i = L: the last layer's output) and returns what the layer takes
        instead: a caller feeds each layer another stream's activations
        (teacher forcing) or reads them."""
        x = self._lookup(self._top(params, "embed")["w"], tokens)  # (C, B, 1, d)
        positions = torch.tensor([cur_pos], device=self.device)
        for i, (block, layer) in enumerate(self._layers(params)):
            if tap is not None:
                x = tap(i, x)
            x, _, _ = apply_block(self._gather_layer(i, layer), x, self.cfg, block, positions,
                                  cache=_layer_cache(cache, i), cur_pos=cur_pos,
                                  tp=self.tp)
        if tap is not None:
            x = tap(self.cfg.num_layers, x)
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
                 _heads(cfg, self.tp)[1], cfg.head_dim)
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
        x = self._lookup(self._top(params, "embed")["w"], tokens)  # (C, S, 1, d)
        tables = torch.as_tensor(tables, device=self.device).to(torch.int32)
        positions = torch.as_tensor(positions, device=self.device).to(torch.int32)
        block = cfg.block_pattern[0]
        for i in range(cfg.num_layers):
            layer_pages = {"k": pages["k"][i], "v": pages["v"][i]}
            x, _ = apply_paged_block(self._gather_layer(i, _layer(params["stack"], i)), x,
                                     cfg, block,
                                     layer_pages, tables, positions, self.tp)
        return self.unembed(params, x), pages


# ===========================================================================
# loss
# ===========================================================================
class _VocabParallelCE(torch.autograd.Function):
    """Each token's log-likelihood ``log p(label)`` from a rank's vocabulary
    slice of the logits (Megatron-LM's vocabulary-parallel cross-entropy):
    the row's max and its sum of exponentials summed over the axis, the
    label's logit from the rank that holds it; backward, the one-hot minus
    the softmax on the rank's slice.  The whole ``(..., V)`` logits are
    never gathered, and every rank gets the same bits."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        import torch.distributed as dist

        x = logits.float()
        n = x.shape[-1]
        top = x.amax(dim=-1)
        all_reduce(top, group, (MODEL_AXIS,), "loss", op=dist.ReduceOp.MAX)
        e = torch.exp(x - top[..., None])
        total = e.sum(dim=-1)
        all_reduce(total, group, (MODEL_AXIS,), "loss")
        t = labels - start
        inside = (t >= 0) & (t < n)
        t = t.clamp(0, n - 1)
        picked = torch.where(inside, x.gather(-1, t[..., None])[..., 0], 0.0)
        all_reduce(picked, group, (MODEL_AXIS,), "loss")
        e /= total[..., None]  # the softmax of the rank's slice
        ctx.save_for_backward(e, t, inside)
        ctx.dtype = logits.dtype
        return (picked - top) - torch.log(total)

    @staticmethod
    def backward(ctx, g):
        p, t, inside = ctx.saved_tensors
        grad = p * -g[..., None]
        grad.scatter_add_(-1, t[..., None], (g * inside)[..., None])
        return grad.to(ctx.dtype), None, None, None


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
    loss.  Under a model axis that splits the head, the log-softmax is
    vocabulary-parallel (:class:`_VocabParallelCE`), the same bits on every
    rank.  Returns ``(total, {"ce": ce, "aux": aux})``, 0-d tensors summed
    over the chains likewise."""
    tokens = model._tokens(batch["tokens"])
    logits, aux, _ = model.forward(params, {**batch, "tokens": tokens[:, :-1]},
                                   layers=layers)
    labels = tokens[:, 1:]
    logits = logits[:, :, -labels.shape[1]:]  # skip the frontend positions
    labels = labels.expand(logits.shape[0], *labels.shape)
    tp = model.tp
    if tp is not None and tp.vocab_out and tp.size > 1:
        ll = _VocabParallelCE.apply(logits, labels, tp.rank * logits.shape[-1], tp.group)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    ce = -ll.mean(dim=(-2, -1))
    total = (ce + model.cfg.router_aux_coef * aux).sum()
    return total, {"ce": ce.sum().detach(), "aux": aux.sum().detach()}
