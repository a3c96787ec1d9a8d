"""Seeded TL005 violations: in-place kernels launched through a raw
pointer with the written tensor handed back, and autograd never told."""

import ctypes

from repro_torch.kernels import build


def _lib():
    return build.load("scale")


def scale_(x, s):
    """x <- x * s in place on the card; returns x."""
    _lib().scale_launch(x.data_ptr(), s.data_ptr(), x.numel())  # expect: TL005
    return x


def push(cache, row, slot: int):
    """Write ``row`` into ``cache`` at ``slot``; returns the cache."""
    lib = ctypes.CDLL("libring.so")
    lib.push_launch(cache.data_ptr(), row.data_ptr(), slot)  # expect: TL005
    return row.sum(), cache


def push_quiet(cache, row, slot: int) -> None:
    """Write ``row`` into ``cache`` at ``slot`` and hand nothing back.  A
    known miss: TL005 knows a written tensor only by the function handing
    it back, so this launch is not flagged (ROADMAP, differences by design)."""
    lib = ctypes.CDLL("libring.so")
    lib.push_launch(cache.data_ptr(), row.data_ptr(), slot)  # known miss: TL005
