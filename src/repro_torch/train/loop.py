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

from typing import Any, Callable

import torch

from repro_torch import samplers
from repro_torch.analysis.cost import repeated
from repro_torch.core.sgld import SGLDConfig
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.train.engine import Engine, log_hook
from repro_torch.utils import tree_add_scaled, tree_leaves, tree_map, tree_zeros_like

PyTree = Any


def _leaf(p: torch.Tensor, grad=None) -> torch.Tensor:
    v = p.detach().requires_grad_()
    if grad is not None:
        v.grad = grad
    return v


def _split_microbatch(batch: PyTree, n: int) -> list:
    return [tree_map(lambda x: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)],
                     batch) for i in range(n)]


def make_grad_fn(model: Model, num_microbatches: int = 1):
    """grad_fn(params, batch) -> (grads, metrics) for the SGLD sampler;
    metrics ``{"ce", "aux", "loss"}`` are 0-d tensors on the device."""

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

    if num_microbatches <= 1:
        return single

    def accumulated(params, batch):
        mbs = _split_microbatch(batch, num_microbatches)
        if tree_leaves(params)[0].device.type == "meta":
            # the microbatches are alike: on meta (the dry run) one, counted
            # num_microbatches times
            return repeated(num_microbatches, single, params, mbs[0])
        g_acc, m_acc = None, None
        for mb in mbs:
            g, m = single(params, mb)
            if g_acc is None:
                g_acc = tree_zeros_like(g)
                m_acc = tree_zeros_like(m)
            g_acc = tree_add_scaled(g_acc, g, 1.0 / num_microbatches)
            m_acc = tree_map(lambda a, b: a + b / num_microbatches, m_acc, m)
        return g_acc, m_acc

    return accumulated


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
