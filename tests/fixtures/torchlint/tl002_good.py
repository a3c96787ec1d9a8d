"""TL002 clean variants: a synchronisation before the write, a fresh
pinned buffer for every copy, or the name rebound to the device copy."""

import torch


def upload(host, device):
    staged = host.pin_memory()
    out = staged.to(device, non_blocking=True)
    torch.cuda.synchronize()
    staged.zero_()
    return out


def stream(chunks, dev_buf):
    for chunk in chunks:
        staging = chunk.pin_memory()
        dev_buf.copy_(staging, non_blocking=True)


def fenced(chunks, dev_buf):
    staging = torch.empty(chunks[0].shape, pin_memory=True)
    for chunk in chunks:
        staging.copy_(chunk)
        dev_buf.copy_(staging, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def moved(x, device):
    x = x.to(device, non_blocking=True)
    x.add_(1)
    return x
