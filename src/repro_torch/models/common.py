"""Shared model components: norms, activations, rotary embeddings, init,
and the sharding rules.

Port of ``repro.models.common``.  The sharding rules (:func:`partition_rules`,
:func:`partition_tree`) are pure functions of leaf path names that return
tuples of mesh axis names; :func:`sanitize_spec` replicates a dimension
the mesh does not divide, :func:`bank_specs` gives a chain bank's 2-D
layout (chains over the chain axis, each chain's tensors over ``model``),
and :class:`ModelAxis` is a rank's place on the ``model`` axis: which of
its tensors are split, its heads, and the collectives over the axis that
the model code runs (tensor and expert parallelism), and which leaves are
split for FSDP and gathered where they are used (``fsdp_full``: every
weight over every axis; ``fsdp_tp``: the experts' ``d_ff`` over the data
axes; :func:`gather_blocks`).  Parameters are plain nested dicts of
tensors, as in the JAX package; initialisers take PRNG keys, as the
reference's do, and draw the reference's numbers: ``jax.random.normal``
(and ``uniform``) bit for bit, scaled and cast as the reference scales and
casts them (:func:`repro_torch.kernels.rng.normal_rows`: the draw kernel on
a card, the plain host-style path on the CPU).  A key table ``lead + (2,)``
(32-bit words as int64) carries one key a row of a leaf's leading axes
(chains, layers): row r of the leaf is the reference's leaf under key r,
what ``jax.vmap`` over split keys gives (:func:`split_keys`).
"""

from __future__ import annotations

import contextlib
import math
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.analysis.cost import multiplier
from repro_torch.kernels import rng
from repro_torch.launch.mesh import axes_group, axis_names, axis_size

PyTree = Any


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
def key_table(key, num=None) -> torch.Tensor:
    """The key table of one key (``(2,)``; ``num`` None) or of the ``num``
    keys ``jax.random.split(key, num)`` (``(num, 2)``), int64 words on the
    host; ``key`` as :func:`repro_torch.kernels.rng.as_key` reads it."""
    key = rng.as_key(key)
    return torch.tensor(key if num is None else rng.split(key, num), dtype=torch.int64)


def meta_keys(lead=()) -> torch.Tensor:
    """A key table on ``meta`` (shapes only: nothing is drawn from it)."""
    return torch.empty(tuple(lead) + (2,), dtype=torch.int64, device="meta")


def split_keys(keys: torch.Tensor, num: int) -> list:
    """``jax.random.split(k, num)`` of every key ``k`` of ``keys`` (``lead +
    (2,)``): ``num`` tables of the same shape, table ``i`` the ``i``-th keys
    (``vmap(split)``).  A table on ``meta`` splits into itself."""
    if keys.device.type == "meta":
        return [keys] * num
    lead = tuple(keys.shape[:-1])
    return [t.reshape(lead + (2,)) for t in rng.split_rows(keys.reshape(-1, 2), num)]


def stack_keys(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``split(k, num)`` of every key of ``keys`` (``lead + (2,)``) as one
    table ``lead + (num, 2)``: the keys of a layer-stacked leaf's rows."""
    if keys.device.type == "meta":
        return meta_keys(tuple(keys.shape[:-1]) + (num,))
    return torch.stack(split_keys(keys, num), dim=-2)


def dense_init(keys, shape, dtype, scale: float | None = None,
               device="cpu") -> torch.Tensor:
    """The reference's ``(std * normal(key, leaf)).astype(dtype)`` with std =
    1/sqrt(fan_in) (or ``scale``), fan_in the leaf's second-to-last axis.
    ``keys`` ``lead + (2,)``: ``shape`` is ``lead + leaf``, row r of the
    leading axes drawn under key r."""
    leaf = _leaf(keys, shape)
    fan_in = leaf[-2] if len(leaf) >= 2 else leaf[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _normal(keys, shape, dtype, "mul", std, device)


def embed_init(keys, shape, dtype, device="cpu") -> torch.Tensor:
    """The reference's ``(0.02 * normal(key, leaf)).astype(dtype)``."""
    return _normal(keys, shape, dtype, "mul", 0.02, device)


def normal_over(keys, shape, dtype, divisor: float, device="cpu") -> torch.Tensor:
    """The reference's ``(normal(key, leaf) / divisor).astype(dtype)``: a
    float32 division (the SSD conv weights, the xLSTM head matrices)."""
    return _normal(keys, shape, dtype, "div", divisor, device)


def uniform_init(keys, shape, minval: float, maxval: float, device="cpu") -> torch.Tensor:
    """The reference's ``uniform(key, leaf, float32, minval, maxval)``."""
    leaf = _leaf(keys, shape)
    return rng.uniform_rows(keys, leaf, minval, maxval, device).reshape(tuple(shape))


def _leaf(keys, shape) -> tuple:
    lead = tuple(keys.shape[:-1])
    if tuple(shape[:len(lead)]) != lead:
        raise ValueError(f"a key table of {lead} rows for a leaf of {tuple(shape)}")
    return tuple(shape[len(lead):])


def repeat_lead(values: torch.Tensor, lead, device="cpu") -> torch.Tensor:
    """A deterministic leaf: ``values`` repeated over the leading axes
    ``lead`` (chains, layers) as a tensor of its own, not a broadcast view
    (the SGLD update writes it in place)."""
    out = torch.empty(tuple(lead) + tuple(values.shape), dtype=values.dtype,
                      device=device)
    if out.device.type == "meta":
        return out
    return out.copy_(values.to(out.device).expand_as(out))


def _normal(keys, shape, dtype, op, c, device) -> torch.Tensor:
    leaf = _leaf(keys, shape)
    return rng.normal_rows(keys, leaf, device, op=op, c=c, dtype=dtype).reshape(
        tuple(shape))


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


# ---------------------------------------------------------------------------
# sharding rules: leaf-path regexp-free suffix matching
# ---------------------------------------------------------------------------
# Each rule: (path_suffix, spec). First match wins.  A spec is a tuple of
# mesh axis names, one entry a dimension: the reference's PartitionSpec as
# a plain tuple.  "mdl" = tensor axis, "fsdp_axes" used only under
# param_sharding == "fsdp_tp".
def _P(*parts) -> tuple:
    return tuple(parts)


def partition_rules(param_sharding: str, fsdp_axes=("data",), cfg=None,
                    model_size: int | None = None):
    mdl = "model"
    fsdp = fsdp_axes  # secondary axes for trillion-scale 2-D sharding
    two_d = param_sharding == "fsdp_tp"
    if param_sharding == "fsdp_full":
        # pure FSDP/ZeRO-3: every weight sharded over ALL data-like+model
        # axes (gathered per layer), batch over all axes, no
        # tensor-parallel activation all-reduces at all
        mdl = tuple(fsdp_axes) + ("model",)
    # head-sharded layout (the reference's opt_attn_head_shard switch; no
    # published config sets it): q heads shard over model (when
    # divisible), k/v params replicate
    head_shard = bool(cfg is not None and getattr(cfg, "opt_attn_head_shard",
                                                  False))
    q_shardable = bool(head_shard and model_size
                       and cfg.num_heads % model_size == 0)
    # Never shard an attention projection finer than its head boundary:
    # splitting one head's head_dim across devices forces cross-shard
    # resharding inside rope/norm/attention.  Unknown cfg/model_size keeps
    # the always-shard rule.
    q_head_ok = bool(cfg is None or not model_size
                     or cfg.num_heads % model_size == 0)
    kv_head_ok = bool(cfg is None or not model_size
                      or cfg.num_kv_heads % model_size == 0)
    if head_shard:
        wq_spec = _P(None, mdl) if q_shardable else _P(None, None)
        wo_spec = _P(mdl, None) if q_shardable else _P(None, None)
        kv_spec = _P(None, None)
        kvb_spec = _P(None)
        qb_spec = _P(mdl) if q_shardable else _P(None)
    else:
        wq_spec = _P(None, mdl) if q_head_ok else _P(None, None)
        wo_spec = _P(mdl, None) if q_head_ok else _P(None, None)
        kv_spec = _P(None, mdl) if kv_head_ok else _P(None, None)
        kvb_spec = _P(mdl) if kv_head_ok else _P(None)
        qb_spec = _P(mdl) if q_head_ok else _P(None)
    rules = [
        # embeddings / head
        ("embed/w", _P(mdl, None)),
        ("lm_head/w", _P(None, mdl)),
        # attention
        ("attn/wq", wq_spec),
        ("attn/wk", kv_spec),
        ("attn/wv", kv_spec),
        ("attn/wo", wo_spec),
        ("attn/bq", qb_spec),
        ("attn/bk", kvb_spec),
        ("attn/bv", kvb_spec),
        ("attn/q_norm", _P(None)),
        ("attn/k_norm", _P(None)),
        # dense mlp
        ("mlp/w_gate", _P(None, mdl)),
        ("mlp/w_up", _P(None, mdl)),
        ("mlp/w_down", _P(mdl, None)),
        # moe: experts over model axis; optionally d_ff over data axis (2-D)
        ("moe/w_gate", _P(mdl, None, fsdp if two_d else None)),
        ("moe/w_up", _P(mdl, None, fsdp if two_d else None)),
        ("moe/w_down", _P(mdl, fsdp if two_d else None, None)),
        ("moe/router", _P(None, None)),
        ("moe/shared_w_gate", _P(None, mdl)),
        ("moe/shared_w_up", _P(None, mdl)),
        ("moe/shared_w_down", _P(mdl, None)),
        # mamba / hymba ssm heads
        ("ssm/in_proj", _P(None, mdl)),
        ("ssm/conv_w", _P(mdl, None)),
        ("ssm/dt_w", _P(None, mdl)),
        ("ssm/dt_bias", _P(mdl)),
        ("ssm/bc_proj", _P(None, None)),
        ("ssm/a_log", _P(mdl)),
        ("ssm/d_skip", _P(mdl)),
        ("ssm/out_proj", _P(mdl, None)),
        # xlstm: batch-parallel with replicated params, as the reference
        # lays them out (its tensor-parallel layouts resharded the (B,S,H,dk)
        # <-> (B,S,di) views at each layer); the port's placed model computes
        # each block whole on every rank of the model axis
        ("mlstm/", _P(None)),
        ("slstm/", _P(None)),
        # frontend projector stub
        ("frontend/proj", _P(None, mdl)),
        # norms & everything 1-D replicated
        ("norm", _P(None)),
    ]
    return rules


def spec_for_path(path: str, rules) -> tuple:
    for suffix, spec in rules:
        if suffix in path:
            return spec
    return ()  # replicate


def partition_tree(params: PyTree, param_sharding: str = "tp",
                   fsdp_axes=("data",), cfg=None,
                   model_size: int | None = None) -> PyTree:
    """Spec tree matching ``params`` (one chain's, without the chain axis,
    as the reference's) by leaf path: each leaf's spec a tuple of mesh
    axis names, one entry a dimension (``None`` = replicated, a tuple =
    several axes)."""
    rules = partition_rules(param_sharding, fsdp_axes, cfg, model_size)

    def visit(path, leaf):
        spec = spec_for_path(path, rules)
        # stacked-layer params carry a leading L axis -> prepend None
        ndim = len(leaf.shape)
        if len(spec) < ndim and "/stack/" in "/" + path + "/":
            spec = (None,) + spec
        return spec[:ndim]

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(tree))
        return visit(path, tree)

    return walk(params, "")


# ---------------------------------------------------------------------------
# the model axis: a spec tree applied, and a rank's place on the axis
# ---------------------------------------------------------------------------
MODEL_AXIS = "model"


def _axes(entry) -> tuple:
    """The mesh axes one spec entry names (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sanitize_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """``spec`` padded or cut to ``len(shape)`` entries, a dimension the
    product of its mesh axes does not divide replicated (the reference's
    ``sanitize_spec``: 25 heads on a 16-way axis, a 32,064 vocabulary on
    128).  ``mesh`` is a ``DeviceMesh`` or a
    :class:`~repro_torch.launch.mesh.MeshShape`."""
    parts = (list(spec) + [None] * len(shape))[:len(shape)]
    for i, entry in enumerate(parts):
        if entry is not None and shape[i] % math.prod(
                axis_size(mesh, a) for a in _axes(entry)):
            parts[i] = None
    return tuple(parts)


def _drop_axis(spec: tuple, axis: str) -> tuple:
    """``spec`` without the mesh axis ``axis`` (an entry left with none is
    replicated)."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _axes(entry) if a != axis)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def model_specs(cfg, mesh, chain_axis=None) -> PyTree:
    """One chain's sanitized spec tree on ``mesh``: :func:`partition_tree`
    of ``cfg``'s parameters (the reference's ``param_sharding`` and
    ``model_size``), each spec through :func:`sanitize_spec`.  An entry
    naming ``chain_axis`` (an axis name or a tuple of them) is replicated:
    that axis holds the chains of a 2-D bank (the reference's
    ``P(chain_axis, *spec)`` would name it twice, which JAX refuses;
    ``fsdp_tp``'s experts name ``data``).  A training chain keeps every
    entry: ``fsdp_tp``'s and ``fsdp_full``'s data entries are FSDP, the
    leaf gathered where it is used."""
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import tree_map

    like = init_params(cfg, None, device="meta")
    model = axis_size(mesh, MODEL_AXIS) if MODEL_AXIS in axis_names(mesh) else None
    fsdp = tuple(a for a in ("pod", "data") if a in axis_names(mesh)) or ("data",)
    specs = partition_tree(like, cfg.param_sharding, fsdp, cfg=cfg, model_size=model)
    drop = (() if chain_axis is None else (chain_axis,) if isinstance(chain_axis, str)
            else tuple(chain_axis))

    def one(leaf, s):
        for a in drop:
            s = _drop_axis(s, a)
        return sanitize_spec(s, tuple(leaf.shape), mesh)

    return tree_map(one, like, specs)


def _spec_at(specs, path: str) -> tuple:
    node = specs
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


def _split(specs, path: str) -> bool:
    """Whether the leaf at ``path`` is split over the model axis."""
    return any(MODEL_AXIS in _axes(e) for e in _spec_at(specs, path))


def _gathered(cfg, mesh, entry):
    """The mesh axes (of more than one rank) one spec entry splits a leaf
    over for FSDP — gathered where the leaf is used — or None: under
    ``fsdp_full`` every entry; otherwise an entry that does not name
    ``model`` (``fsdp_tp``'s experts' ``d_ff`` over the data axes), a
    ``model`` entry being tensor or expert parallelism."""
    axes = _axes(entry)
    if cfg.param_sharding != "fsdp_full" and MODEL_AXIS in axes:
        return None
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return axes or None


@dataclass(frozen=True)
class ModelAxis:
    """A rank's place on a mesh's ``model`` axis, for a model config: the
    ``mesh``, the axis' ``size`` and this rank's index ``rank`` on it, its
    process ``group``, and which of the model's tensors the sanitized specs
    (:func:`model_specs`) split over it.  The model code reads:

    - ``heads``: ``(H, KV, q0, kv0)`` — the rank's query heads ``[q0, q0 +
      H)`` and KV heads ``[kv0, kv0 + KV)``; ``kv_take`` when the K/V
      projection is replicated and the rank takes the KV heads its query
      heads read from it (``opt_attn_head_shard``'s layout, or KV heads the
      axis does not divide); ``attn``: the query heads are split, so the
      output projection's rows are and its product is a partial sum;
    - ``mlp``: the dense MLP is column- / row-parallel;
    - ``vocab_in`` / ``vocab_out``: the embedding's rows / the head's
      columns (or the tied embedding's rows) are the rank's slice of the
      vocabulary;
    - ``experts``: the experts a rank holds (0: no MoE), ``shared``: the
      shared experts are column- / row-parallel;
    - ``batch_axes``: the mesh axes a training batch is split over (the
      MoE's capacity and aux are a shard's; empty for a 2-D serving bank,
      whose other axis holds chains);
    - ``summed``: the paths (one chain's, ``"stack/attn/q_norm"``) of the
      leaves that are replicated on the axis but that a rank uses on its
      part only — the qk-norms on its heads, a replicated K/V projection's
      columns under ``kv_take``, the router beside its experts — whose
      gradient is a rank's part, summed over the axis by the gradient
      function (:func:`repro_torch.train.loop.make_grad_fn`).  A replicated
      leaf whose computation is replicated (the norms of the residual
      stream, a projection :func:`sanitize_spec` replicated, an xLSTM
      block) has its whole gradient on every rank;
    - ``ssm``: ``(c0, c1)``, the SSD channels ``[c0, c1)`` of ``di = 2
      d_model`` the rank computes (None: no SSD heads, or not split), a
      run of ``di / m`` that may cut a head; ``ssm_gather``: the SSD
      leaves whose block is split over ``model`` by the reference's
      specs, each name with the dimension of one layer's ``(C, ...)``
      tensor it is split on.  A rank gathers those whole where the layer
      runs (``in_proj``'s ``[xi | z]`` columns, ``conv_w``'s taps,
      ``dt_w``'s heads and the per-head vectors: the reference's blocks
      lay them out over another dimension than the channels; the gather's
      backward sums the ranks' parts) and uses its channels of every SSD
      leaf; ``out_proj``'s rows are its channels already (row-parallel).
      The replicated SSD leaves (``bc_proj``, ``conv_b``, ``norm``, and
      those the axis does not divide) join ``summed``;
    - ``gathers``: one chain's tree beside the parameters, each leaf's
      entry a dimension the mesh axes its block is split over for FSDP
      (:func:`_gathered`; None: not gathered), and ``fsdp`` whether any
      leaf is.  The model gathers a block whole where it uses it
      (:meth:`gather`, :func:`gather_blocks`: an all-gather, its backward
      the gradient summed over the axes, each rank its block) — a layer's
      leaves as the layer runs, under a checkpoint, so that no rank holds
      two layers gathered.

    On an axis of one rank nothing is tensor-parallel: the model computes
    the unplaced path.  Under ``fsdp_full`` (the reference's ``"fsdp"``
    option) the model is not tensor-parallel either: every weight is split over every axis of the mesh
    and gathered where it is used, the batch over every axis, no collective
    on the activations; ``model`` may be a batch axis.  A MoE is refused
    there, as the reference's option is for dense configs.

    The collectives are differentiable (:func:`copy_to` at the entry of a
    column-parallel region, :func:`reduce_from` at a row-parallel exit and
    after the vocabulary-parallel lookup, :func:`gather_from`), so a loss
    over the model's outputs backpropagates to every rank's block.

    Refused: a MoE whose experts the axis does not divide, and a query
    block that straddles a group of query heads (no uniform local group
    the decode kernels could take)."""

    mesh: Any
    size: int
    rank: int
    group: Any
    heads: tuple
    kv_take: bool
    attn: bool
    mlp: bool
    vocab_in: bool
    vocab_out: bool
    experts: int
    shared: bool
    summed: frozenset = frozenset()
    batch_axes: tuple = ()
    gathers: Any = None
    fsdp: bool = False
    ssm: tuple | None = None
    ssm_gather: Any = None

    @classmethod
    def of(cls, mesh, cfg, batch_axes=(), chain_axis=None) -> "ModelAxis":
        """``chain_axis``: the mesh axis a 2-D serving bank holds its chains
        on, whose spec entries are replicated (:func:`model_specs`); None
        for a training chain."""
        from repro_torch.models.transformer import init_params
        from repro_torch.utils import paired_leaves, tree_map

        if MODEL_AXIS not in axis_names(mesh):
            raise ValueError(f"the mesh has no {MODEL_AXIS!r} axis to split each "
                             f"chain's tensors over (its axes: {axis_names(mesh)})")
        full = cfg.param_sharding == "fsdp_full"
        batch_axes = tuple(batch_axes)
        if any(a not in axis_names(mesh) or (a == MODEL_AXIS and not full)
               for a in batch_axes):
            raise ValueError(f"batch_axes {batch_axes} must name axes of the mesh other "
                             f"than {MODEL_AXIS!r} (its axes: {axis_names(mesh)}; "
                             f"only fsdp_full splits the batch over {MODEL_AXIS!r})")
        m = axis_size(mesh, MODEL_AXIS)
        r = mesh.get_local_rank(MODEL_AXIS)
        E = cfg.num_experts
        if full and E:
            raise ValueError(f"{cfg.name}: fsdp_full is for dense configs ({E} experts; "
                             "the reference's 'fsdp' option asserts the same)")
        if full and chain_axis is not None:
            raise ValueError(f"{cfg.name}: fsdp_full lays out a training chain, not a "
                             f"2-D bank whose {chain_axis!r} axis holds chains")
        if E and E % m:
            raise ValueError(f"{cfg.name}: {E} experts do not divide over the "
                             f"{MODEL_AXIS!r} axis of size {m} (expert parallelism "
                             "holds E / m experts a rank)")
        specs = model_specs(cfg, mesh, chain_axis)
        like = init_params(cfg, None, device="meta")
        gathers = tree_map(lambda _, s: tuple(_gathered(cfg, mesh, e) for e in s),
                           like, specs)
        fsdp = any(any(g) for g in paired_leaves(like, gathers))
        H, KV = cfg.num_heads, cfg.num_kv_heads
        common = dict(mesh=mesh, size=m, rank=r, group=mesh.get_group(MODEL_AXIS),
                      batch_axes=batch_axes, gathers=gathers, fsdp=fsdp)
        if full or m == 1:  # nothing tensor-parallel: gathered, or an axis of one
            return cls(heads=(H, KV, 0, 0), kv_take=False, attn=False, mlp=False,
                       vocab_in=False, vocab_out=False, experts=E, shared=False,
                       **common)
        heads, kv_take, attn = (H, KV, 0, 0), False, False
        if "stack" in specs and "attn" in specs["stack"]:
            attn = _split(specs, "stack/attn/wq")
            if attn and _split(specs, "stack/attn/wk"):
                heads = (H // m, KV // m, r * H // m, r * KV // m)
            elif attn:  # K/V replicated: the KV heads the rank's queries read
                G, h = H // KV, H // m
                if h % G == 0:
                    heads, kv_take = (h, h // G, r * h, r * h // G), True
                elif G % h == 0:
                    heads, kv_take = (h, 1, r * h, r * h // G), True
                else:
                    raise ValueError(
                        f"{cfg.name}: {h} query heads a rank over groups of {G} "
                        f"({H} query heads, {KV} KV heads, K/V replicated on the "
                        f"{MODEL_AXIS!r} axis of size {m}): a rank's query block "
                        "straddles a group, so no uniform local group exists for "
                        "the decode kernels")
        stack = specs.get("stack", {})
        tied = cfg.tie_embeddings
        ssm, ssm_gather, ssm_summed = _ssm_split(cfg, stack.get("ssm"), m, r)
        summed = [f"attn/{n}" for n in ("q_norm", "k_norm") if attn] \
            + [f"attn/{n}" for n in ("wk", "wv", "bk", "bv") if kv_take] \
            + (["moe/router"] if E else []) + [f"ssm/{n}" for n in ssm_summed]
        summed = frozenset(f"stack/{n}" for n in summed
                           if n.split("/")[1] in stack.get(n.split("/")[0], {}))
        return cls(ssm=ssm, ssm_gather=ssm_gather,
            heads=heads, kv_take=kv_take, attn=attn,
            mlp="mlp" in stack and _split(specs, "stack/mlp/w_down"),
            vocab_in=_split(specs, "embed/w"),
            vocab_out=_split(specs, "embed/w" if tied else "lm_head/w"),
            experts=E // m if E else 0,
            shared="moe" in stack and "shared_w_down" in stack["moe"]
            and _split(specs, "stack/moe/shared_w_down"),
            summed=summed, **common)

    # -- collectives over the axis (identity on an axis of one rank) ---------
    def copy_to(self, t: torch.Tensor) -> torch.Tensor:
        """The entry of a column-parallel region: ``t`` itself, its gradient
        summed over the axis (:func:`copy_to`)."""
        return copy_to(t, self.group) if self.size > 1 else t

    def reduce_from(self, t: torch.Tensor) -> torch.Tensor:
        """The exit of a row-parallel region: the sum of ``t`` over the
        axis' ranks, every rank the same bits, its gradient passed through
        (:func:`reduce_from`)."""
        return reduce_from(t, self.group) if self.size > 1 else t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order; the
        gradient of the rank's slice is its slice of the whole's
        (:func:`gather_from`)."""
        return gather_from(t, self.group, dim) if self.size > 1 else t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial ``t`` (every rank the same bits),
        entering a region where each rank computes its part: forward and
        backward one all-reduce each (:func:`reduce_from`, then
        :func:`copy_to`)."""
        return self.copy_to(self.reduce_from(t))

    # -- the SSD heads split by channel ----------------------------------------
    def ssm_leaves(self, layer: dict, keep=()) -> dict:
        """One layer's SSD leaves ``(C, ...)``, those of :attr:`ssm_gather`
        but ``keep`` gathered whole over the axis (their gradient's
        backward summed over it, each rank its block), the others as they
        are."""
        return {name: gather_blocks(t, self.group, self.ssm_gather[name], (MODEL_AXIS,),
                                    fsdp=False)
                if name in self.ssm_gather and name not in keep else t
                for name, t in layer.items()}

    def gather_columns(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' column blocks of ``t`` concatenated along its last
        axis, each rank using its part of the whole: backward, the
        gradient summed over the axis, each rank its block."""
        return gather_blocks(t, self.group, t.dim() - 1, (MODEL_AXIS,), fsdp=False)

    def rms_norm(self, x: torch.Tensor, scale: torch.Tensor, width: int,
                 eps: float) -> torch.Tensor:
        """:func:`rms_norm` over a last axis of ``width`` split over the
        axis, ``x`` the rank's run of it: the sum of squares all-reduced in
        float32 (:meth:`all_sum`)."""
        dt = x.dtype
        x = x.float()
        var = self.all_sum((x * x).sum(dim=-1, keepdim=True)) / width
        return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)

    # -- FSDP ----------------------------------------------------------------
    def gather(self, tree, gathers, skip: int = 0):
        """``tree``'s leaves (a rank's blocks with the chain axis in front)
        whole where ``gathers`` (the matching subtree of :attr:`gathers`)
        names FSDP axes; ``skip`` leading spec entries are absent from the
        tensors (1 for one layer of a stack: its ``L``)."""
        from repro_torch.utils import tree_map

        def one(t, g):
            for d, axes in enumerate(g[skip:]):
                if axes:
                    t = gather_blocks(t, axes_group(self.mesh, axes), 1 + d, axes)
            return t

        return tree_map(one, tree, gathers)

    def gathered_axes(self, path: str) -> tuple:
        """The FSDP axes the leaf at ``path`` (one chain's) is split over."""
        return tuple(a for g in _spec_at(self.gathers, path) if g for a in g)


#: the SSD leaves whose blocks split something else than the rank's run of
#: channels; out_proj's rows are that run (row-parallel)
_SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "bc_proj", "dt_w", "dt_bias", "a_log",
               "d_skip", "norm")


def _ssm_split(cfg, specs, m: int, r: int) -> tuple:
    """``(channels, gathered, summed)`` of the SSD heads on a model axis of
    ``m`` ranks (rank ``r``), from one layer's sanitized SSD specs (with the
    stack's ``L`` in front; None: no SSD heads): the run of ``di / m``
    channels the rank computes, the leaves split over ``model`` (each with
    the dimension a layer's ``(C, ...)`` tensor splits) and the replicated
    ones the rank uses its channels of.  ``(None, None, ())`` where the
    axis has one rank."""
    if specs is None or m == 1:
        return None, None, ()
    di = 2 * cfg.d_model
    if di % m or not any(MODEL_AXIS in _axes(e) for e in specs["out_proj"]):
        raise ValueError(f"{cfg.name}: the SSD heads' {di} channels do not divide over "
                         f"the {MODEL_AXIS!r} axis of size {m}")
    gathered, summed = {}, []
    for name in _SSM_LEAVES:
        dims = [d for d, e in enumerate(specs[name]) if MODEL_AXIS in _axes(e)]
        if dims:
            gathered[name] = dims[0]  # the layer tensor's (C, ...) puts C where L was
        else:
            summed.append(name)
    return (r * di // m, (r + 1) * di // m), gathered, tuple(summed)


# ---------------------------------------------------------------------------
# collectives with gradients (Megatron-LM's tensor-parallel mappings, FSDP)
# ---------------------------------------------------------------------------
# The ranks of an axis compute one loss, the same bits on every rank.  A
# replicated tensor that enters a region where each rank computes its part
# (its heads, columns, experts, vocabulary slice) goes through copy_to:
# each rank's gradient of it is its part's, and the backward sums them.  A
# region's partial results leave it through reduce_from: the forward sums
# them, and the gradient of the sum reaches every rank's part whole.  A
# ``dist.all_reduce`` alone has no autograd formula: PyTorch would treat it
# as the identity in the backward and leave out the sum over the ranks.
#: the collectives the model's code has issued since :func:`reset_collectives`,
#: by kind: ``forward`` (row-parallel exits, the lookup, the MoE's aux, a
#: gather), ``backward`` (column-parallel entries), ``loss`` (the
#: vocabulary-parallel cross-entropy's), ``model sum`` and ``data mean``
#: (the gradient function's, once a step), ``fsdp gather`` and ``fsdp
#: reduce`` (FSDP's gather of a leaf and its backward)
COLLECTIVES: Counter = Counter()
#: what those collectives moved on this rank, by ``(op, axes)`` —
#: ``op`` ``"all_reduce"`` (the buffer's bytes) or ``"all_gather"`` (the
#: result's), ``axes`` the mesh axes of the group — as ``[calls, bytes]``,
#: each times the loop multiplier of a count on ``meta``
#: (:func:`repro_torch.analysis.cost.repeated`): the dry run's collective
#: term
TRAFFIC: dict = {}
#: FSDP's gathered bytes alive now and at most since
#: :func:`reset_collectives` (each gathered tensor counted until it is freed)
GATHERED = {"alive": 0, "peak": 0}
_REPLAY = [False]


def count_collective(kind: str, n: int = 1, op: str | None = None, axes=(),
                     t: torch.Tensor | None = None) -> None:
    """One more collective of ``kind`` (``n`` of them); with ``op``, its
    bytes (``t``'s) over the mesh ``axes`` go to :data:`TRAFFIC`."""
    COLLECTIVES[kind] += n
    if op is not None:
        entry = TRAFFIC.setdefault((op, tuple(axes)), [0, 0])
        m = multiplier()
        entry[0] += n * m
        entry[1] += n * m * t.numel() * t.element_size()


def reset_collectives() -> None:
    COLLECTIVES.clear()
    TRAFFIC.clear()
    GATHERED.update(alive=GATHERED["alive"], peak=GATHERED["alive"])


def replaying() -> bool:
    """True while a checkpointed layer is recomputed for its backward: what
    counts an event once a step (the MoE's dropped pairs) counts nothing."""
    return _REPLAY[0]


@contextlib.contextmanager
def replay(on: bool = True):
    prev = _REPLAY[0]
    _REPLAY[0] = on
    try:
        yield
    finally:
        _REPLAY[0] = prev


def all_reduce(t: torch.Tensor, group, axes, kind: str, op=None) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (the mesh
    ``axes``), counted as ``kind``."""
    import torch.distributed as dist

    count_collective(kind, 1, "all_reduce", axes, t)
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t


def _release(nbytes: int) -> None:
    GATHERED["alive"] -= nbytes


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, axes):
        ctx.group, ctx.axes = group, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce(g, ctx.group, ctx.axes, "backward")
        return g, None, None


class _SumFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, axes):
        out = t.clone(memory_format=torch.contiguous_format)
        all_reduce(out, group, axes, "forward")
        return out if n == 1 else out / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        import torch.distributed as dist

        from repro_torch.utils import all_gather

        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        out = all_gather(t, group, dim)
        count_collective("forward", 1, "all_gather", (MODEL_AXIS,), out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _GatherBlocks(torch.autograd.Function):
    """FSDP's gather of a leaf: forward, the group's blocks concatenated
    along ``dim`` in rank order; backward, the rank's block of the
    gradient summed over the group.  The sum is one all-reduce of the whole
    gradient and the rank's slice of it — a reduce-scatter's result, from
    the collective that both gloo on a card's tensors and NCCL take.
    ``fsdp`` False: a tensor-parallel region's gather (the SSD leaves),
    counted as ``forward`` / ``backward`` and not in :data:`GATHERED`."""

    @staticmethod
    def forward(ctx, t, group, dim, axes, fsdp):
        import torch.distributed as dist

        from repro_torch.utils import all_gather

        ctx.group, ctx.dim, ctx.n, ctx.axes = group, dim, t.shape[dim], axes
        ctx.rank = dist.get_rank(group)
        ctx.kind = "fsdp reduce" if fsdp else "backward"
        out = all_gather(t, group, dim)
        count_collective("fsdp gather" if fsdp else "forward", 1, "all_gather", axes, out)
        if fsdp:
            nbytes = out.numel() * out.element_size()
            GATHERED["alive"] += nbytes
            GATHERED["peak"] = max(GATHERED["peak"], GATHERED["alive"])
            weakref.finalize(out, _release, nbytes)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce(g, ctx.group, ctx.axes, ctx.kind)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


def copy_to(t: torch.Tensor, group, axes=(MODEL_AXIS,)) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over ``group`` (the
    mesh ``axes``)."""
    return _CopyTo.apply(t, group, tuple(axes))


def reduce_from(t: torch.Tensor, group, axes=(MODEL_AXIS,)) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (one ``dist.all_reduce``, every rank
    the same bits); backward, the gradient passed through."""
    return _SumFrom.apply(t, group, 1, tuple(axes))


def mean_value(t: torch.Tensor, group, n: int, axes=()) -> torch.Tensor:
    """The mean of ``t`` over the ``n`` ranks of ``group`` (a batch axis);
    backward, each rank's gradient of its own ``t``, which the caller
    averages over the axis with the rest of the gradient
    (:func:`repro_torch.train.loop.make_grad_fn`)."""
    return _SumFrom.apply(t, group, n, tuple(axes))


def gather_from(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``group``'s ranks' ``t`` concatenated along ``dim``; backward, the
    rank's slice of the gradient."""
    return _GatherFrom.apply(t, group, dim)


def gather_blocks(t: torch.Tensor, group, dim: int, axes, fsdp: bool = True) -> torch.Tensor:
    """FSDP's gather: ``group``'s blocks of a leaf (over the mesh ``axes``,
    the first major) concatenated along ``dim``; backward, the gradient
    summed over ``group``, each rank its block (:class:`_GatherBlocks`;
    ``fsdp`` False for a tensor-parallel region's)."""
    return _GatherBlocks.apply(t, group, dim, tuple(axes), fsdp)
