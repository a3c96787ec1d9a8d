"""Training-loop substrate: the gradient oracle of the LM loss, with
microbatch accumulation, wired into an SGLD preset, and ``train_loop``,
which drives it through the chunked
:class:`~repro_torch.train.engine.Engine` (port of ``repro.train.loop``).

Gradients come from autograd.  The model reads its layer-stacked
``stack`` leaves one layer at a time; differentiating through those
slices would make autograd allocate a full-size zero gradient of every
stacked leaf for every layer.  So the oracle differentiates per-layer
leaves instead — views of the parameters, detached — whose ``.grad`` is
preset to the matching view of one zeroed gradient tree: each layer's
gradient is accumulated in place where it belongs, and the whole gradient
costs one parameter-sized tree.  A heterogeneous stack's ``layers`` list
(xLSTM) needs no slicing: each entry's leaves are autograd leaves as they
are.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch import samplers
from repro_torch.analysis.cost import repeated
from repro_torch.core.sgld import SGLDConfig
from repro_torch.kernels import rng
from repro_torch.launch.mesh import axis_size
from repro_torch.models.common import MODEL_AXIS, all_reduce
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.train.engine import Engine, log_hook
from repro_torch.utils import (
    local,
    place_like,
    tree_add_scaled,
    tree_leaves,
    tree_map,
    tree_zeros_like,
)

PyTree = Any


def _leaf(p: torch.Tensor, grad=None) -> torch.Tensor:
    v = p.detach().requires_grad_()
    if grad is not None:
        v.grad = grad
    return v


def _split_microbatch(batch: PyTree, n: int) -> list:
    return [tree_map(lambda x: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)],
                     batch) for i in range(n)]


def microbatch_rows(model: Model, batch_size: int, n: int) -> list:
    """The rows of a global batch of ``batch_size`` that this rank takes,
    one slice a microbatch, as the reference splits them under GSPMD:
    microbatch ``i`` of ``n`` is rows ``[i B/n, (i+1) B/n)`` (a reshape),
    split over ``model.batch_axes`` in mesh order, so data rank ``d`` of
    ``D`` takes ``[i B/n + d B/(nD), i B/n + (d+1) B/(nD))``.  Without
    batch axes, the whole microbatches.

    Where a microbatch does not split over the ``D`` shards but the batch
    does (a ``fsdp_full`` batch over every axis: ``train_4k``'s 64-row
    microbatches over 256 ranks), a dense model's rank takes its ``B / D``
    rows of the batch as GSPMD lays it out, in ``gcd(n, B / D)``
    microbatches: every microbatch the same size, the mean over them and
    the shards is the mean over the batch, as the reference's.  A MoE's
    capacity is a shard's, so there it is refused."""
    tp = model.tp
    axes = () if tp is None else tp.batch_axes
    D, d = 1, 0
    for a in axes:
        size = axis_size(tp.mesh, a)
        D, d = D * size, d * size + tp.mesh.get_local_rank(a)
    if batch_size % n == 0 and (batch_size // n) % D == 0:
        per, sub = batch_size // n, batch_size // n // D
        return [slice(i * per + d * sub, i * per + (d + 1) * sub) for i in range(n)]
    if batch_size % D or model.cfg.num_experts:
        raise ValueError(f"a global batch of {batch_size} does not split into {n} "
                         f"microbatches over {D} shards of {axes}")
    own = batch_size // D
    m = math.gcd(n, own)
    return [slice(d * own + i * (own // m), d * own + (i + 1) * (own // m))
            for i in range(m)]


def _reduce_placed(model: Model, grads: PyTree, metrics: dict) -> dict:
    """Once a step, in place: the leaves of ``model.tp.summed`` summed over
    ``model`` (a rank's part of their gradient), then every leaf and the
    metrics averaged over the batch axes, every rank the same bits.

    An FSDP leaf's gradient came back from its gather's backward already
    summed over the axes its block is split over: it is all-reduced only
    over the batch axes outside those (never twice), and divided by the
    batch shards and by the ranks of those axes that hold the same rows
    (an axis that splits the leaf but not the batch, ``model`` when a
    ``fsdp_full`` batch does not divide over it)."""
    from repro_torch.checkpoint.io import leaf_paths

    tp = model.tp
    axes = [a for a in tp.batch_axes if axis_size(tp.mesh, a) > 1]
    D = math.prod(axis_size(tp.mesh, a) for a in axes)
    for path, g in leaf_paths(grads):
        path = path.replace("##", "/")
        if tp.size > 1 and path in tp.summed:
            all_reduce(g, tp.group, (MODEL_AXIS,), "model sum")
        summed = tp.gathered_axes(path)
        for a in axes:
            if a not in summed:
                all_reduce(g, tp.mesh.get_group(a), (a,), "data mean")
        n = D * math.prod(axis_size(tp.mesh, a) for a in summed if a not in axes)
        if n > 1:
            g.div_(n)
    if not axes:
        return metrics
    names = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in names])
    for a in axes:
        all_reduce(vals, tp.mesh.get_group(a), (a,), "data mean")
    vals = vals / D
    return {k: vals[i] for i, k in enumerate(names)}


def make_grad_fn(model: Model, num_microbatches: int = 1):
    """grad_fn(params, batch) -> (grads, metrics) for the SGLD sampler;
    metrics ``{"ce", "aux", "loss"}`` are 0-d tensors on the device.

    On a model split over a mesh (``Model(cfg, mesh=..., batch_axes=...)``)
    ``params`` are the rank's blocks (placed ``DTensor``s or local tensors)
    and ``batch`` the whole global batch on every rank: each rank takes its
    rows of each microbatch (:func:`microbatch_rows`), runs the forward and
    backward of its part, and accumulates locally; after the last
    microbatch the leaves a rank computed from its part alone
    (``model.tp.summed``) are summed over ``model``, and every leaf and the
    metrics are averaged over the batch axes.  The gradients come back
    placed as ``params`` are, the metrics the same bits on every rank.
    This is what the reference's GSPMD step computes; its MoE gives each
    data shard its own capacity."""

    def single(params, batch):
        if "stack" in params:
            gstack = tree_zeros_like(params["stack"])
            layers = [tree_map(lambda p, g, i=i: _leaf(p[:, i], g[:, i]),
                               params["stack"], gstack)
                      for i in range(model.cfg.num_layers)]
        else:
            layers = tree_map(_leaf, params["layers"])
        top = {k: tree_map(_leaf, v) for k, v in params.items()
               if k not in ("stack", "layers")}
        with torch.enable_grad():
            loss, metrics = loss_fn(model, top, batch, layers=layers)
            loss.backward()
        grads = {k: tree_map(lambda v: v.grad, t) for k, t in top.items()}
        if "stack" in params:
            grads["stack"] = gstack
        else:
            # a layer the dry run counts through another has no gradient on meta
            grads["layers"] = tree_map(lambda v: torch.zeros_like(v) if v.grad is None
                                       else v.grad, layers)
        return grads, dict(metrics, loss=loss.detach())

    if model.tp is not None:
        def placed(params, batch):
            size = tree_leaves(batch)[0].shape[0]
            rows = microbatch_rows(model, size, max(1, num_microbatches))
            mbs = [tree_map(lambda x, r=r: x[r], batch) for r in rows]
            if tree_leaves(params)[0].device.type == "meta":  # alike: one, n times
                grads, metrics = repeated(len(mbs), single, local(params), mbs[0])
            else:
                grads, metrics = _accumulate(single, local(params), mbs)
            metrics = _reduce_placed(model, grads, metrics)
            return place_like(grads, params), metrics

        return placed

    if num_microbatches <= 1:
        return single

    def accumulated(params, batch):
        mbs = _split_microbatch(batch, num_microbatches)
        if tree_leaves(params)[0].device.type == "meta":
            # the microbatches are alike: on meta (the dry run) one, counted
            # num_microbatches times
            return repeated(num_microbatches, single, params, mbs[0])
        return _accumulate(single, params, mbs)

    return accumulated


def _accumulate(single, params, mbs: list) -> tuple:
    """``single``'s gradients and metrics averaged over the microbatches
    ``mbs``, accumulated as the reference's scan does (from zeros, each
    scaled by ``1 / n``); one microbatch's as they are."""
    if len(mbs) == 1:
        return single(params, mbs[0])
    g_acc, m_acc = None, None
    for mb in mbs:
        g, m = single(params, mb)
        if g_acc is None:
            g_acc = tree_zeros_like(g)
            m_acc = tree_zeros_like(m)
        g_acc = tree_add_scaled(g_acc, g, 1.0 / len(mbs))
        m_acc = tree_map(lambda a, b: a + b / len(mbs), m_acc, m)
        del g  # not held through the next microbatch's backward
    return g_acc, m_acc


def make_train_step(model: Model, sgld_cfg: SGLDConfig,
                    num_microbatches: int = 1, *, fused: bool = False):
    """Returns (sampler, step_fn); step_fn(state, batch, delay) -> (state, metrics)."""
    grad_fn = make_grad_fn(model, num_microbatches)
    sampler = samplers.from_config(sgld_cfg, grad_fn, has_aux=True, fused=fused)

    def step_fn(state, batch, delay=0):
        return sampler.step(state, batch, delay)

    return sampler, step_fn


def train_loop(model: Model, params: PyTree, sgld_cfg: SGLDConfig,
               batch_fn: Callable[[torch.Generator], PyTree], steps: int, key,
               delays=None, log_every: int = 10, log_fn=print,
               num_microbatches: int = 1, chunk_size: int = 0, *, fused: bool = False):
    """Train through the chunked :class:`~repro_torch.train.engine.Engine`,
    logging through :func:`~repro_torch.train.engine.log_hook`.

    ``key`` is a JAX-style key (``rng.PRNGKey(seed)``) or an int seed of
    one: ``key, init_key = split(key)`` as the JAX package splits it, the
    sampler's state under ``init_key``, and ``batch_fn(generator)`` drawing
    from a ``torch.Generator`` seeded from ``key``.  Returns ``(state,
    history)`` with history ``[(step, loss), ...]`` at the ``log_every``
    cadence and the last step."""
    sampler, _ = make_train_step(model, sgld_cfg, num_microbatches, fused=fused)
    key = rng.PRNGKey(key) if isinstance(key, int) else rng.key_bits(key)
    key, init_key = rng.split(key)
    state = sampler.init(params, init_key)
    engine = Engine(sampler, batch_fn=batch_fn,
                    chunk_size=chunk_size or max(1, log_every),
                    hooks=[log_hook(every=log_every, log_fn=log_fn)])
    state, aux = engine.run(state, steps=steps, delays=delays,
                            key=rng.seed_int(key))
    losses = aux["loss"]
    idx = sorted(set(range(0, steps, log_every)) | {steps - 1})
    return state, [(k, float(losses[k])) for k in idx]
