"""ctypes wrappers of the CUDA W-Icon kernels (``csrc/delay_gather.cu``).

:func:`wicon_read` is the training path's W-Icon read of one leaf in one
launch: each coordinate's delay ``d_i`` is drawn in registers, bit for bit
``jax.random.randint`` (``csrc/randint.cuh``), and ``out[i] =
history[(head - d_i) mod depth, i]`` is read from the ring ``(depth, N)``
— no delay array is allocated or written.  :func:`delay_gather` is the
same kernel with the delays read from an int32 array (any value, the slot
taken with ``torch.remainder``'s semantics): the counterpart of
``repro.kernels.delay_gather.delay_gather_1d``.  :func:`coordinate_delays`
draws the delays alone, bit for bit ``jax.random.randint`` (the same
device function).  The source's header says more.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, raise on anything else, allocate the output with
``torch.empty``, launch on the current stream and raise if the launch
fails.  Each keeps a launch count (``wicon_read.launches``,
``delay_gather.launches``, ``coordinate_delays.launches``) raised nowhere
else.  The plain versions are
:func:`repro_torch.kernels.ref.wicon_read_ref`,
:func:`~repro_torch.kernels.ref.delay_gather_ref` and
:func:`~repro_torch.kernels.ref.coordinate_delays_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, rng

_GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _lib():
    lib = build.load("delay_gather")
    if not getattr(lib, "_typed", False):
        p, i, u, ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong
        lib.delay_gather_launch.argtypes = [p, p, p, ull, i, i, i, p]
        lib.delay_gather_launch.restype = i
        lib.wicon_read_launch.argtypes = [p, p, ull, i, i, u, u, u, u, u, u, ull, i, p]
        lib.wicon_read_launch.restype = i
        lib.coordinate_delays_launch.argtypes = [p, ull, u, u, u, u, u, u, ull, p]
        lib.coordinate_delays_launch.restype = i
        lib._typed = True
    return lib


def _check_history(history, what: str):
    build.require_cuda(history, what)
    if history.dim() != 2 or history.dtype not in _GATHER_DTYPES:
        raise ValueError(f"{what}: history must be (depth, N) of "
                         f"{_GATHER_DTYPES}, got {tuple(history.shape)} "
                         f"{history.dtype}")
    if not history.is_contiguous():
        raise ValueError(f"{what}: history must be contiguous")
    if history.shape[1] > 2**32:
        raise ValueError(f"{what}: {history.shape[1]} elements (at most 2^32)")


def _check_draw(maxval: int, n: int, what: str):
    if not 1 <= int(maxval) < 2**16 or not 1 <= n <= 2**32:
        raise ValueError(f"{what}: maxval {maxval} (1 .. 2^16-1), "
                         f"n {n} (1 .. 2^32)")


def delay_gather(history: torch.Tensor, delays: torch.Tensor, head: int):
    """W-Icon read on the card, delays from an array.

    history: (depth, N) contiguous CUDA tensor (float32, bfloat16 or
    int32); delays: (N,) int32 on the same device, any value (the slot is
    ``(head - delays[i]) mod depth``); head: the ring slot of the newest
    snapshot.  Returns out (N,) in history's dtype."""
    _check_history(history, "delay_gather")
    depth, n = history.shape
    if tuple(delays.shape) != (n,) or delays.dtype != torch.int32:
        raise ValueError(f"delay_gather: delays must be ({n},) int32, got "
                         f"{tuple(delays.shape)} {delays.dtype}")
    if delays.device != history.device:
        raise ValueError("delay_gather: delays on another device")
    if not delays.is_contiguous():
        raise ValueError("delay_gather: delays must be contiguous")
    if not 0 <= int(head) < depth:
        raise ValueError(f"delay_gather: head {head} outside the {depth}-slot ring")
    out = torch.empty(n, dtype=history.dtype, device=history.device)
    if n == 0:
        return out
    with torch.cuda.device(history.device):
        stream = torch.cuda.current_stream(history.device).cuda_stream
        err = _lib().delay_gather_launch(
            history.data_ptr(), delays.data_ptr(), out.data_ptr(), n, depth,
            int(head), history.element_size(), stream)
    build.check_launch(err, "delay_gather")
    delay_gather.launches += 1
    return out


delay_gather.launches = 0


def wicon_read(history: torch.Tensor, key, maxval: int, head: int):
    """The one-pass W-Icon read on the card: ``out[i] = history[(head -
    d_i) mod depth, i]`` with ``d_i = jax.random.randint(key, (N,), 0,
    maxval, int32)[i]`` drawn in the kernel.

    history: (depth, N) contiguous CUDA tensor (float32, bfloat16 or
    int32), N <= 2^32; key: ``(k0, k1)`` ints; maxval: 1 .. min(depth,
    2^16 - 1); head: the ring slot of the newest snapshot.  Returns out
    (N,) in history's dtype."""
    _check_history(history, "wicon_read")
    depth, n = history.shape
    if not 1 <= int(maxval) <= depth:
        raise ValueError(f"wicon_read: maxval {maxval} outside 1 .. depth {depth}")
    if not 0 <= int(head) < depth:
        raise ValueError(f"wicon_read: head {head} outside the {depth}-slot ring")
    out = torch.empty(n, dtype=history.dtype, device=history.device)
    if n == 0:
        return out
    _check_draw(maxval, n, "wicon_read")
    k_hi, k_lo, span, mult = rng.randint_params(key, maxval)
    with torch.cuda.device(history.device):
        stream = torch.cuda.current_stream(history.device).cuda_stream
        err = _lib().wicon_read_launch(
            history.data_ptr(), out.data_ptr(), n, depth, int(head), k_hi[0],
            k_hi[1], k_lo[0], k_lo[1], span, mult, rng.fastmod_magic(span),
            history.element_size(), stream)
    build.check_launch(err, "wicon_read")
    wicon_read.launches += 1
    return out


wicon_read.launches = 0


def coordinate_delays(key, n: int, maxval: int, device) -> torch.Tensor:
    """Per-coordinate delays on the card: ``jax.random.randint(key, (n,),
    0, maxval, int32)`` bit for bit, 1 <= maxval < 2^16, n <= 2^32.
    key: ``(k0, k1)`` ints; returns (n,) int32 on ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"coordinate_delays launches a CUDA kernel; got "
                         f"device {device} (the plain version is in kernels.ref)")
    _check_draw(maxval, n, "coordinate_delays")
    k_hi, k_lo, span, mult = rng.randint_params(key, maxval)
    out = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().coordinate_delays_launch(
            out.data_ptr(), n, k_hi[0], k_hi[1], k_lo[0], k_lo[1], span, mult,
            rng.fastmod_magic(span), stream)
    build.check_launch(err, "coordinate_delays")
    coordinate_delays.launches += 1
    return out


coordinate_delays.launches = 0
