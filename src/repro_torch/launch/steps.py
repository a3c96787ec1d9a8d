"""Step builders for the dry run and the launcher (port of
``repro.launch.steps``).

For each (arch, shape) this module builds the step function — train,
prefill or decode — that :mod:`repro_torch.launch.dryrun` runs on ``meta``
tensors and ``chip_smoke.py`` runs on the card.  The reference's sharding
helpers are here: :func:`sanitize_spec` (a dimension the mesh does not
divide replicated), :func:`named` (a spec tree as ``DTensor`` placements
on a ``DeviceMesh``), :func:`param_structs` (a config's parameters on
``meta`` with their placements) and :func:`batch_specs` (a step's batch
with its placements over the batch axes); :func:`place_params` places a
training chain on a ``(data, model)`` mesh.  ``cache_spec_tree``, which
places a dry run's decode cache, is not ported yet (ROADMAP).

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

from dataclasses import replace
from typing import Any

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.models.common import partition_tree, sanitize_spec
from repro_torch.models.transformer import Model, init_params
from repro_torch.samplers.transforms import noise_like as langevin_noise
from repro_torch.samplers.transforms import sgld_apply as apply_update
from repro_torch.train.loop import make_grad_fn
from repro_torch.utils import local, place_like

PyTree = Any

LONG_CONTEXT_WINDOW = 8192  # sliding window applied to attention archs @500k
#: the reference's switches that change how XLA or a mesh lays the step
#: out, which the port does not have: FSDP (``"fsdp"``) waits for its slice
_MESH_OPTS = ("window_slice", "fsdp", "unroll")


def adapt_config(cfg: ArchConfig, shape: ShapeConfig,
                 opts: tuple = ()) -> ArchConfig:
    """Shape-dependent config changes, as the reference's: an attention
    architecture without a window gets an 8,192-token one at
    ``long_500k``; ``"attn_shard"`` sets ``opt_attn_head_shard`` (the
    query heads over ``model``, K/V replicated); ``"padvocab"`` pads the
    vocabulary to a multiple of 256.  The reference's other mesh and XLA
    switches are refused."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",) \
            and cfg.sliding_window is None:
        cfg = replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    unknown = [o for o in opts if o not in ("padvocab", "attn_shard")]
    if unknown:
        raise ValueError(f"opts {unknown}: of the reference's switches the "
                         f"port has 'attn_shard' and 'padvocab' (the others, "
                         f"{_MESH_OPTS}, lay a step out over a mesh)")
    if "attn_shard" in opts:
        cfg = replace(cfg, opt_attn_head_shard=True)
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
    (``model.batch_axes``)."""
    from repro_torch.launch.mesh import batch_axes_for

    cfg = adapt_config(cfg, shape, opts)
    if mesh is None:
        return Model(cfg, device=device), cfg
    return Model(cfg, device=device, mesh=mesh,
                 batch_axes=batch_axes_for(mesh, shape.global_batch)), cfg


def place_params(params: PyTree, model: Model) -> PyTree:
    """A whole bank of one placed for ``model``'s mesh: each leaf cut to the
    rank's block by its sanitized spec (:func:`~repro_torch.models.common.
    model_specs`; an entry naming a batch axis replicated — ``fsdp_tp``'s
    experts' ``data``, whose FSDP is not ported) with the chain axis
    replicated, copied (the whole may be freed), and placed as a
    ``DTensor``.  No collective runs."""
    from repro_torch.models.common import model_specs
    from repro_torch.utils import chain_placements, local_block, place_chains, tree_map

    tp = model.tp
    if tp is None:
        raise ValueError("place_params places a chain for a model split over a mesh: "
                         "build it with mesh=")
    specs = model_specs(model.cfg, tp.mesh, ("pod", "data"))
    blocks = tree_map(lambda x, spec: local_block(
        x, tp.mesh, chain_placements(tp.mesh, None, spec=spec)).clone(), params, specs)
    return place_chains(blocks, tp.mesh, None, specs)


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
