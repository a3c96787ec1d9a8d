"""TL005 clean variants: the in-place launch bumps the version counter (or
marks the tensor dirty in an autograd Function); a kernel that writes an
output the function allocated, or that only reads its operands, needs
neither."""

import ctypes

import torch

from repro_torch.kernels import build


def _lib():
    return build.load("scale")


def scale_(x, s):
    _lib().scale_launch(x.data_ptr(), s.data_ptr(), x.numel())
    torch.autograd.graph.increment_version(x)
    return x


def scaled(x, s):
    out = torch.empty_like(x)
    lib = _lib()
    lib.scale_out_launch(x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel())
    return out


def total(x):
    out = torch.empty(1, device=x.device)
    ctypes.CDLL("libsum.so").sum_launch(x.data_ptr(), out.data_ptr())
    return out


class ScaleInPlace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        _lib().scale_launch(x.data_ptr(), s.data_ptr(), x.numel())
        ctx.mark_dirty(x)
        return x
