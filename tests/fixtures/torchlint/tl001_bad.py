"""Seeded TL001 violations: callables compiled or captured for fixed shapes
fed a loop-varying Python scalar — every distinct value recompiles (or
re-captures)."""

import torch


@torch.compile
def step(x, n):
    return x * n


def run(batches):
    out = []
    for batch in batches:
        # the unpadded length changes per batch -> one compile per length
        out.append(step(batch, int(batch.shape[0])))  # expect: TL001
    return out


def replay(model, xs):
    graphed = torch.cuda.make_graphed_callables(model, (xs[0],))
    for x in xs:
        graphed(x, x.size(0))  # expect: TL001
