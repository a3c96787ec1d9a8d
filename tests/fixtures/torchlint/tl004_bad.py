"""Seeded TL004 violations: host syncs and branches on tensors inside an
autograd Function, a compiled function and a step body marked hot."""

import torch


class Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.bound = bound
        return x.clamp(-bound, bound)

    @staticmethod
    def backward(ctx, g):
        if g.abs().max() > 1e3:  # expect: TL004
            g = g / 2
        return g, None


@torch.compile
def loss(params, batch):
    err = params - batch
    return err.sum().item()  # expect: TL004


def make_step(grad_fn):
    def step(params: torch.Tensor, batch):  # torchlint: hot
        g = grad_fn(params, batch)
        scale = float(torch.linalg.norm(g))  # expect: TL004
        torch.cuda.synchronize()  # expect: TL004
        return params - 1e-3 * g / scale, g.cpu()  # expect: TL004

    return step
