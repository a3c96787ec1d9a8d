"""Step builders for the dry run and the launcher (port of
``repro.launch.steps``).

For each (arch, shape) this module builds the step function — train,
prefill or decode — that :mod:`repro_torch.launch.dryrun` runs on ``meta``
tensors and ``chip_smoke.py`` runs on the card.  The reference's sharding
helpers that place parameters on a mesh are here: :func:`sanitize_spec`
(a dimension the mesh does not divide replicated), :func:`named` (a spec
tree as ``DTensor`` placements on a ``DeviceMesh``) and
:func:`param_structs` (a config's parameters on ``meta`` with their
placements).  ``batch_specs`` and ``cache_spec_tree``, which place a
training step's batch and a dry run's cache, are not ported yet (ROADMAP).

SGLD modes:
  - ``sync``      the paper-faithful Sync step: the gradient of this step's
                  parameters, then the update;
  - ``pipeline``  the paper's tau = 1 W-Con: apply last step's gradient
                  (``pending``), compute this step's for the next.

The step functions take a **chain bank of one**: parameters with a
leading chain axis of 1 (``init_params(..., num_chains=1)``), the port's
layout, where the reference's take one chain's tree.
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

PyTree = Any

LONG_CONTEXT_WINDOW = 8192  # sliding window applied to attention archs @500k
#: the reference's switches that change how XLA or a mesh lays the step
#: out, not what it computes; the port has none of them
_MESH_OPTS = ("attn_shard", "window_slice", "fsdp", "unroll")


def adapt_config(cfg: ArchConfig, shape: ShapeConfig,
                 opts: tuple = ()) -> ArchConfig:
    """Shape-dependent config changes, as the reference's: an attention
    architecture without a window gets an 8,192-token one at
    ``long_500k``; ``"padvocab"`` pads the vocabulary to a multiple of
    256.  The reference's mesh and XLA switches are refused."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",) \
            and cfg.sliding_window is None:
        cfg = replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    unknown = [o for o in opts if o != "padvocab"]
    if unknown:
        raise ValueError(f"opts {unknown}: of the reference's switches the "
                         f"port has only 'padvocab' (the others, {_MESH_OPTS}, "
                         "lay a step out over a mesh)")
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


def build_model(cfg: ArchConfig, shape: ShapeConfig, opts: tuple = (),
                device="cuda"):
    """``(model, adapted config)`` for an (arch, shape) on ``device``
    (``"meta"`` for the dry run)."""
    cfg = adapt_config(cfg, shape, opts)
    return Model(cfg, device=device), cfg


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def make_sgld_train_step(model: Model, shape: ShapeConfig, mode: str = "sync",
                         gamma: float = 1e-5, sigma: float = 1e-6):
    """Full training step: microbatched gradients + SGLD update.

    sync:     params' = params - gamma * g(params) + noise
    pipeline: params' = params - gamma * pending  + noise; pending' = g(params)

    ``key`` is a JAX-style key (``rng.PRNGKey``); the noise is drawn per
    leaf under its split key (:func:`~repro_torch.samplers.transforms.
    noise_like`), sqrt(2 sigma gamma) in float32."""
    grad_fn = make_grad_fn(model, shape.num_microbatches)
    scale = (2.0 * sigma * gamma) ** 0.5

    if mode == "sync":
        def step(params, batch, key):
            grads, metrics = grad_fn(params, batch)
            noise = langevin_noise(key, params, scale, torch.float32)
            return apply_update(params, grads, gamma, noise), metrics["loss"]
        return step

    if mode == "pipeline":
        def step(params, pending, batch, key):
            grads, metrics = grad_fn(params, batch)
            noise = langevin_noise(key, params, scale, torch.float32)
            return apply_update(params, pending, gamma, noise), grads, metrics["loss"]
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
