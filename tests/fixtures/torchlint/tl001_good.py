"""TL001 clean variants: the loop passes tensors padded to a fixed bucket
(the length rides along as a tensor), so every iteration reuses one
compiled program; a plain function takes any scalar."""

import torch

BUCKET = 64


@torch.compile
def step(x, n):
    return x * n


def scale(x, n):
    return x * n


def run(batches):
    out = []
    for batch in batches:
        padded = torch.zeros(BUCKET, dtype=batch.dtype)
        padded[:batch.shape[0]] = batch
        out.append(step(padded, torch.as_tensor(batch.shape[0])))
        out.append(scale(batch, int(batch.shape[0])))
    return out
