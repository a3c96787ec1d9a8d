"""Step builders for the dry run and the launcher (port of
``repro.launch.steps``).

For each (arch, shape) this module builds the step function — train,
prefill or decode — that :mod:`repro_torch.launch.dryrun` runs on ``meta``
tensors and ``chip_smoke.py`` runs on the card.  The reference's sharding
helpers are here: :func:`sanitize_spec` (a dimension the mesh does not
divide replicated), :func:`named` (a spec tree as ``DTensor`` placements
on a ``DeviceMesh``), :func:`param_structs` (a config's parameters on
``meta`` with their placements) and :func:`batch_specs` (a step's batch
with its placements over the batch axes), :func:`cache_spec_tree` (a
decode cache on ``meta`` with its placements); :func:`place_params` places
a training chain on a mesh, tensor-parallel, ``fsdp_tp`` or ``fsdp_full``
(the ``"fsdp"`` option: every weight over every axis, the batch too).

SGLD modes:
  - ``sync``      the paper-faithful Sync step: the gradient of this step's
                  parameters, then the update;
  - ``pipeline``  the paper's tau = 1 W-Con: apply last step's gradient
                  (``pending``), compute this step's for the next.

The step functions take a **chain bank of one**: parameters with a
leading chain axis of 1 (``init_params(..., num_chains=1)``), the port's
layout, where the reference's take one chain's tree.  On a model built
with a mesh (:func:`build_model`'s ``mesh=``: the reference's GSPMD step)
they take the rank's placed blocks (:func:`place_params`) and the whole
global batch on every rank, and return the new parameters (and
``pending``) placed alike; the loss is the same bits on every rank.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Any

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.models.common import MODEL_AXIS as MODEL
from repro_torch.models.common import partition_tree, sanitize_spec
from repro_torch.models.transformer import Model, init_params
from repro_torch.samplers.transforms import noise_like as langevin_noise
from repro_torch.samplers.transforms import sgld_apply as apply_update
from repro_torch.train.loop import make_grad_fn
from repro_torch.utils import local, place_like

PyTree = Any

LONG_CONTEXT_WINDOW = 8192  # sliding window applied to attention archs @500k
#: the reference's switches, every one
OPTS = ("attn_shard", "window_slice", "fsdp", "unroll", "padvocab")


def adapt_config(cfg: ArchConfig, shape: ShapeConfig,
                 opts: tuple = ()) -> ArchConfig:
    """Shape-dependent config changes, as the reference's: an attention
    architecture without a window gets an 8,192-token one at
    ``long_500k``; ``"attn_shard"`` sets ``opt_attn_head_shard`` (the
    query heads over ``model``, K/V replicated); ``"window_slice"`` sets
    ``opt_window_slice``, which changes no step: the port's windowed flash
    path reads only the in-window key chunks either way; ``"fsdp"`` sets ``param_sharding="fsdp_full"`` (every
    weight over every axis, gathered where it is used; the batch over every
    axis) and clears ``opt_attn_head_shard`` — for dense configs only, a
    MoE is refused as the reference asserts; ``"unroll"`` sets
    ``opt_unroll_layers``, which changes no step: the port's layers are
    always a Python loop, each FSDP gather a layer's; ``"padvocab"`` pads
    the vocabulary to a multiple of 256.  Another name is refused."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",) \
            and cfg.sliding_window is None:
        cfg = replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    unknown = [o for o in opts if o not in OPTS]
    if unknown:
        raise ValueError(f"opts {unknown}: the switches are {OPTS}")
    if "attn_shard" in opts:
        cfg = replace(cfg, opt_attn_head_shard=True)
    if "window_slice" in opts:
        cfg = replace(cfg, opt_window_slice=True)
    if "fsdp" in opts:
        if cfg.num_experts:
            raise ValueError(f"{cfg.name}: the 'fsdp' option is for dense configs "
                             f"({cfg.num_experts} experts)")
        cfg = replace(cfg, param_sharding="fsdp_full", opt_attn_head_shard=False)
    if "unroll" in opts:
        cfg = replace(cfg, opt_unroll_layers=True)
    if "padvocab" in opts:
        v = -(-cfg.vocab_size // 256) * 256
        cfg = replace(cfg, vocab_size=v)
    return cfg


def named(mesh, spec_tree: PyTree) -> PyTree:
    """Each spec of ``spec_tree`` (a tuple of mesh axis names a dimension)
    as the ``DTensor`` placements it gives on ``mesh`` (the reference's
    ``NamedSharding``s)."""
    from repro_torch.utils import spec_placements

    return _map_specs(lambda s: spec_placements(mesh, s), spec_tree)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return fn(tree)


def param_structs(cfg: ArchConfig, mesh, fsdp_axes=("data",)):
    """``(params on meta, placements)`` of one chain of ``cfg`` on
    ``mesh``: :func:`~repro_torch.models.common.partition_tree`'s specs
    through :func:`sanitize_spec`, as :func:`named` places them (nothing
    is allocated)."""
    from repro_torch.launch.mesh import axis_names, axis_size
    from repro_torch.utils import tree_map

    shapes = init_params(cfg, device="meta")
    model = axis_size(mesh, "model") if "model" in axis_names(mesh) else None
    specs = partition_tree(shapes, cfg.param_sharding, fsdp_axes, cfg=cfg,
                           model_size=model)
    specs = tree_map(lambda x, s: sanitize_spec(s, tuple(x.shape), mesh), shapes, specs)
    return shapes, named(mesh, specs)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, batch_axes,
                kind=None):
    """``(batch on meta, placements)`` of a step's inputs
    (:func:`~repro_torch.data.make_specs`): each array's rows split over
    ``batch_axes`` (replicated where there are none), a 0-d or host value
    replicated.  A training step's rank takes its rows of each microbatch
    (:func:`~repro_torch.train.loop.microbatch_rows`) from the whole."""
    from torch.distributed.tensor import Replicate

    from repro_torch.data import make_specs
    from repro_torch.utils import spec_placements

    specs = make_specs(cfg, shape, kind)
    rows = tuple(batch_axes) or None

    def placements(leaf):
        if not torch.is_tensor(leaf) or leaf.dim() == 0:
            return [Replicate()] * mesh.ndim
        return spec_placements(mesh, (rows,) + (None,) * (leaf.dim() - 1))

    return specs, {k: placements(v) for k, v in specs.items()}


def build_model(cfg: ArchConfig, shape: ShapeConfig, opts: tuple = (),
                device="cuda", mesh=None):
    """``(model, adapted config)`` for an (arch, shape) on ``device``
    (``"meta"`` for the dry run).  With ``mesh`` (a ``DeviceMesh`` with a
    ``model`` axis) the model is split over it, its batch over the axes
    :func:`~repro_torch.launch.mesh.batch_axes_for` gives
    (``model.batch_axes``) — under ``fsdp_full`` over every axis
    (:func:`~repro_torch.launch.mesh.fsdp_full_axes_for`) when the global
    batch divides by the mesh's size, as the reference's."""
    from repro_torch.launch.mesh import (
        axis_size,
        batch_axes_for,
        fsdp_full_axes_for,
    )

    cfg = adapt_config(cfg, shape, opts)
    if mesh is None:
        return Model(cfg, device=device), cfg
    baxes = batch_axes_for(mesh, shape.global_batch)
    every = fsdp_full_axes_for(mesh)
    if cfg.param_sharding == "fsdp_full" and \
            shape.global_batch % math.prod(axis_size(mesh, a) for a in every) == 0:
        baxes = every
    return Model(cfg, device=device, mesh=mesh, batch_axes=baxes), cfg


def param_blocks(params: PyTree, model: Model) -> tuple:
    """``(blocks, specs)``: each leaf of a whole bank of one cut to this
    rank's block for ``model``'s mesh by its sanitized spec
    (:func:`~repro_torch.models.common.model_specs`, every entry kept:
    ``fsdp_tp``'s and ``fsdp_full``'s data entries are FSDP) with the chain
    axis replicated, copied (the whole may be freed)."""
    from repro_torch.models.common import model_specs
    from repro_torch.utils import chain_placements, local_block, tree_map

    tp = model.tp
    if tp is None:
        raise ValueError("place_params places a chain for a model split over a mesh: "
                         "build it with mesh=")
    specs = model_specs(model.cfg, tp.mesh)
    blocks = tree_map(lambda x, spec: local_block(
        x, tp.mesh, chain_placements(tp.mesh, None, spec=spec)).clone(), params, specs)
    return blocks, specs


def param_bytes(cfg: ArchConfig, mesh) -> int:
    """One chain's parameter bytes a rank holds on ``mesh`` (a
    ``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.MeshShape`): each
    leaf's block under its sanitized spec (:func:`~repro_torch.models.
    common.model_specs`), what :func:`param_blocks` cuts."""
    from repro_torch.launch.mesh import axis_size
    from repro_torch.models.common import model_specs
    from repro_torch.utils import paired_leaves, tree_leaves

    like = init_params(cfg, device="meta")
    specs = model_specs(cfg, mesh)
    return sum(t.numel() * t.element_size() // math.prod(
        axis_size(mesh, a) for e in spec if e for a in ((e,) if isinstance(e, str) else e))
        for t, spec in zip(tree_leaves(like), paired_leaves(like, specs)))


def place_params(params: PyTree, model: Model) -> PyTree:
    """A whole bank of one placed for ``model``'s mesh: each leaf cut to the
    rank's block (:func:`param_blocks`) and placed as a ``DTensor``: under
    ``fsdp_full`` a rank holds ``1 / (pod · data · model)`` of each leaf the
    mesh divides, under ``fsdp_tp`` its experts with their ``d_ff`` over
    the data axes.  No collective runs."""
    from repro_torch.utils import place_chains

    blocks, specs = param_blocks(params, model)
    return place_chains(blocks, model.tp.mesh, None, specs)


def cache_specs(model: Model, cfg: ArchConfig, shape: ShapeConfig, mesh,
                batch_axes) -> tuple:
    """``(cache on meta, sanitized specs)`` of the decode cache of ``shape``
    (``model.init_cache(global_batch, seq_len, prefill_len=seq_len - 1)``
    of one chain, whole) on ``mesh`` (a ``DeviceMesh`` or a
    :class:`~repro_torch.launch.mesh.MeshShape`): the reference's
    ``cache_spec_tree`` rules on the port's tree, whose leaves carry a
    chain axis (``(L, C, ...)`` for a stack, ``(C, ...)`` for an xLSTM
    layer; the ring's ``pos`` has none) — the rows over ``batch_axes``,
    the SSD heads, the conv channels, the mLSTM ``dv``, the sLSTM width
    over ``model``.  One difference by design: the attention ring splits
    its KV heads over ``model``, not ``head_dim`` as the reference's does,
    since the port's ring cache and page pool hold a rank's KV heads whole
    (each decode kernel reads whole heads); :func:`sanitize_spec` then
    replicates them where ``model`` does not divide them.  Where the rows
    are split over ``model`` too (a ``fsdp_full`` batch over every axis) the
    ``model`` entries are replicated: the reference's spec would name
    ``model`` twice, which JAX refuses."""
    cache = Model(cfg, device="meta").init_cache(shape.global_batch, shape.seq_len,
                                                 prefill_len=shape.seq_len - 1)
    bd = tuple(batch_axes) or None
    stacked = len(cfg.block_pattern) == 1

    def spec_for(path: str, nd: int) -> tuple:
        name = path.rsplit("/", 1)[-1]
        lead = (None, None) if stacked else (None,)  # (L, C) or (C,)
        if name == "pos":
            return (None,) * nd
        if path.startswith("attn/") or "/attn/" in path:  # (L, C, B, S, KV, hd)
            parts = lead + (bd, None, MODEL, None)
        elif name == "ssm_h":  # (L, C, B, H, p, n)
            parts = lead + (bd, MODEL, None, None)
        elif name == "ssm_conv":  # (L, C, B, K-1, di)
            parts = lead + (bd, None, MODEL)
        elif name == "mlstm_c":  # (C, B, H, dk, dv)
            parts = lead + (bd, None, None, MODEL)
        elif name.startswith(("mlstm_", "slstm_")):
            parts = lead + (bd,) + ((MODEL,) if name.startswith("slstm_") else ())
        else:
            parts = ()
        if bd and MODEL in bd:  # a fsdp_full batch over every axis holds model already
            parts = tuple(None if e == MODEL else e for e in parts)
        return (tuple(parts) + (None,) * nd)[:nd]

    specs = _map_paths(lambda path, x: sanitize_spec(spec_for(path, x.dim()),
                                                     tuple(x.shape), mesh), cache)
    return cache, specs


def cache_spec_tree(model: Model, cfg: ArchConfig, shape: ShapeConfig, mesh,
                    batch_axes) -> tuple:
    """``(decode cache on meta, placements)`` on the ``DeviceMesh``
    ``mesh``: :func:`cache_specs`' specs as :func:`named` places them
    (the reference's ``cache_spec_tree``)."""
    cache, specs = cache_specs(model, cfg, shape, mesh, batch_axes)
    return cache, named(mesh, specs)


def _map_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the keys
    and indices joined by ``/``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def make_sgld_train_step(model: Model, shape: ShapeConfig, mode: str = "sync",
                         gamma: float = 1e-5, sigma: float = 1e-6, noise=None):
    """Full training step: microbatched gradients + SGLD update.

    sync:     params' = params - gamma * g(params) + noise
    pipeline: params' = params - gamma * pending  + noise; pending' = g(params)

    ``key`` is a JAX-style key (``rng.PRNGKey``); the noise is drawn per
    leaf under its split key (:func:`~repro_torch.samplers.transforms.
    noise_like`), sqrt(2 sigma gamma) in float32: from a
    ``torch.Generator`` (``noise="torch"``, the default without a mesh) or
    ``jax.random.normal``'s numbers (``"jax"``).  On a model split over a
    mesh the step takes placed parameters (:func:`place_params`) and the
    whole batch, each rank draws its block of the ``"jax"`` noise (the
    default there; ``"torch"`` is refused), and its new parameters are its
    block of what the unplaced step gives, within rounding."""
    placed = model.tp is not None
    noise = noise or ("jax" if placed else "torch")
    if placed and noise != "jax":
        raise ValueError(f"noise={noise!r} on a model split over a mesh: each rank "
                         "draws its block of the whole leaf's noise at its counters, "
                         "which only noise='jax' can")
    grad_fn = make_grad_fn(model, shape.num_microbatches)
    scale = (2.0 * sigma * gamma) ** 0.5

    def update(params, grads, key):
        z = langevin_noise(key, params, scale, torch.float32, noise)
        return place_like(apply_update(local(params), local(grads), gamma, local(z)),
                          params)

    if mode == "sync":
        def step(params, batch, key):
            grads, metrics = grad_fn(params, batch)
            return update(params, grads, key), metrics["loss"]
        return step

    if mode == "pipeline":
        def step(params, pending, batch, key):
            grads, metrics = grad_fn(params, batch)
            return update(params, pending, key), grads, metrics["loss"]
        return step

    raise ValueError(mode)


def make_prefill_step(model: Model):
    def step(params, batch):
        return model.prefill(params, batch)
    return step


def make_decode_step(model: Model):
    def step(params, cache, batch):
        return model.serve_step(params, cache, batch["tokens"], batch["cur_pos"])
    return step
