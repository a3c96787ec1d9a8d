"""Seeded TL002 violations: a host buffer handed to a non_blocking copy is
written again before any synchronisation — the card may still be reading
it."""

import torch


def upload(host, device):
    staged = host.pin_memory()
    out = staged.to(device, non_blocking=True)
    staged.zero_()  # expect: TL002
    return out


def stream(chunks, dev_buf):
    staging = torch.empty(chunks[0].shape, pin_memory=True)
    for chunk in chunks:
        # the next iteration writes the buffer the last copy still reads
        staging[:] = chunk  # expect: TL002
        dev_buf.copy_(staging, non_blocking=True)
