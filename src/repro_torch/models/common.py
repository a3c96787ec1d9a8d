"""Shared model components: norms, activations, rotary embeddings, init,
and the sharding rules.

Port of ``repro.models.common``.  The sharding rules (:func:`partition_rules`,
:func:`partition_tree`) are pure functions of leaf path names that return
tuples of mesh axis names; :func:`sanitize_spec` replicates a dimension
the mesh does not divide, :func:`bank_specs` gives a chain bank's 2-D
layout (chains over the chain axis, each chain's tensors over ``model``),
and :class:`ModelAxis` is a rank's place on the ``model`` axis: which of
its tensors are split, its heads, and the collectives over the axis that
the model code runs (tensor and expert parallelism).  Parameters are plain nested dicts of
tensors, as in the JAX package; initialisers draw from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s — a test that
needs both packages on the same weights carries them over with
:func:`repro_torch.weights.from_jax_params`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_names, axis_size

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
        # <-> (B,S,di) views at each layer)
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


def model_specs(cfg, mesh, chain_axis: str | None = None) -> PyTree:
    """One chain's sanitized spec tree on ``mesh``: :func:`partition_tree`
    of ``cfg``'s parameters (the reference's ``param_sharding`` and
    ``model_size``), each spec through :func:`sanitize_spec`.  An entry
    naming ``chain_axis`` is replicated: that axis holds the chains (the
    reference's ``P(chain_axis, *spec)`` would name it twice, which JAX
    refuses; ``fsdp_tp``'s experts name ``data``)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import tree_map

    like = init_params(cfg, device="meta")
    model = axis_size(mesh, MODEL_AXIS) if MODEL_AXIS in axis_names(mesh) else None
    fsdp = tuple(a for a in ("pod", "data") if a in axis_names(mesh)) or ("data",)
    specs = partition_tree(like, cfg.param_sharding, fsdp, cfg=cfg, model_size=model)
    return tree_map(lambda leaf, s: sanitize_spec(
        s if chain_axis is None else _drop_axis(s, chain_axis), tuple(leaf.shape), mesh),
        like, specs)


def _spec_at(specs, path: str) -> tuple:
    node = specs
    for k in path.split("/"):
        node = node[k]
    return node


def _split(specs, path: str) -> bool:
    """Whether the leaf at ``path`` is split over the model axis."""
    return any(MODEL_AXIS in _axes(e) for e in _spec_at(specs, path))


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
      shared experts are column- / row-parallel.

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

    @classmethod
    def of(cls, mesh, cfg) -> "ModelAxis":
        if MODEL_AXIS not in axis_names(mesh):
            raise ValueError(f"the mesh has no {MODEL_AXIS!r} axis to split each "
                             f"chain's tensors over (its axes: {axis_names(mesh)})")
        m = axis_size(mesh, MODEL_AXIS)
        r = mesh.get_local_rank(MODEL_AXIS)
        E = cfg.num_experts
        if E and E % m:
            raise ValueError(f"{cfg.name}: {E} experts do not divide over the "
                             f"{MODEL_AXIS!r} axis of size {m} (expert parallelism "
                             "holds E / m experts a rank)")
        specs = model_specs(cfg, mesh)
        H, KV = cfg.num_heads, cfg.num_kv_heads
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
        return cls(
            mesh=mesh, size=m, rank=r, group=mesh.get_group(MODEL_AXIS), heads=heads,
            kv_take=kv_take, attn=attn,
            mlp="mlp" in stack and _split(specs, "stack/mlp/w_down"),
            vocab_in=_split(specs, "embed/w"),
            vocab_out=_split(specs, "embed/w" if tied else "lm_head/w"),
            experts=E // m if E else 0,
            shared="moe" in stack and "shared_w_down" in stack["moe"]
            and _split(specs, "stack/moe/shared_w_down"))

    # -- collectives over the axis (identity on an axis of one rank) ---------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis' ranks, in place (every rank gets
        the same bits)."""
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        from repro_torch.utils import all_gather

        return all_gather(t, self.group, dim)

