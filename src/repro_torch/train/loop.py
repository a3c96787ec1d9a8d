"""Training-loop substrate: the gradient oracle of the LM loss, with
microbatch accumulation, wired into an SGLD preset (port of
``repro.train.loop``'s ``make_grad_fn`` and ``make_train_step``).

Gradients come from autograd.  The model reads its layer-stacked
``stack`` leaves one layer at a time; differentiating through those
slices would make autograd allocate a full-size zero gradient of every
stacked leaf for every layer.  So the oracle differentiates per-layer
leaves instead — views of the parameters, detached — whose ``.grad`` is
preset to the matching view of one zeroed gradient tree: each layer's
gradient is accumulated in place where it belongs, and the whole gradient
costs one parameter-sized tree.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import samplers
from repro_torch.core.sgld import SGLDConfig
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.utils import tree_add_scaled, tree_map, tree_zeros_like

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
        stack = params["stack"]
        gstack = tree_zeros_like(stack)
        L = model.cfg.num_layers
        layers = [tree_map(lambda p, g, i=i: _leaf(p[:, i], g[:, i]), stack, gstack)
                  for i in range(L)]
        top = {k: tree_map(_leaf, v) for k, v in params.items() if k != "stack"}
        with torch.enable_grad():
            loss, metrics = loss_fn(model, {**top, "stack": stack}, batch,
                                    layers=layers)
            loss.backward()
        grads = {k: tree_map(lambda v: v.grad, t) for k, t in top.items()}
        grads["stack"] = gstack
        return grads, dict(metrics, loss=loss.detach())

    if num_microbatches <= 1:
        return single

    def accumulated(params, batch):
        g_acc, m_acc = None, None
        for mb in _split_microbatch(batch, num_microbatches):
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
