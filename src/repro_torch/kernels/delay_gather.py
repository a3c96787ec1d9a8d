"""ctypes wrappers of the CUDA W-Icon kernels (``csrc/delay_gather.cu``).

:func:`delay_gather` replaces ``repro.kernels.delay_gather.delay_gather_1d``:
``out[i] = history[(head - delays[i]) mod depth, i]`` over one leaf's ring
``(depth, N)``, a true gather of the selected element (bound by bytes).
:func:`coordinate_delays` draws the per-coordinate delays it reads, bit for
bit ``jax.random.randint`` (bound by integer operations).  The source's
header says more.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, raise on anything else, allocate the output with
``torch.empty``, launch on the current stream and raise if the launch
fails.  Each keeps a launch count (``delay_gather.launches``,
``coordinate_delays.launches``) raised nowhere else.  The plain versions
are :func:`repro_torch.kernels.ref.delay_gather_ref` and
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
        p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.delay_gather_launch.argtypes = [p, p, p, ll, i, i, i, p]
        lib.delay_gather_launch.restype = i
        lib.coordinate_delays_launch.argtypes = [p, ll, u, u, u, u, u, u, p]
        lib.coordinate_delays_launch.restype = i
        lib._typed = True
    return lib


def delay_gather(history: torch.Tensor, delays: torch.Tensor, head: int):
    """W-Icon read on the card.

    history: (depth, N) contiguous CUDA tensor (float32, bfloat16 or
    int32); delays: (N,) int32 on the same device; head: the ring slot
    of the newest snapshot.  Returns out (N,) in history's dtype."""
    build.require_cuda(history, "delay_gather")
    if history.dim() != 2 or history.dtype not in _GATHER_DTYPES:
        raise ValueError(f"delay_gather: history must be (depth, N) of "
                         f"{_GATHER_DTYPES}, got {tuple(history.shape)} "
                         f"{history.dtype}")
    depth, n = history.shape
    if tuple(delays.shape) != (n,) or delays.dtype != torch.int32:
        raise ValueError(f"delay_gather: delays must be ({n},) int32, got "
                         f"{tuple(delays.shape)} {delays.dtype}")
    if delays.device != history.device:
        raise ValueError("delay_gather: delays on another device")
    if not (history.is_contiguous() and delays.is_contiguous()):
        raise ValueError("delay_gather: history and delays must be contiguous")
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


def coordinate_delays(key, n: int, maxval: int, device) -> torch.Tensor:
    """Per-coordinate delays on the card: ``jax.random.randint(key, (n,),
    0, maxval, int32)`` bit for bit, 1 <= maxval < 2^16, n <= 2^32.
    key: ``(k0, k1)`` ints; returns (n,) int32 on ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"coordinate_delays launches a CUDA kernel; got "
                         f"device {device} (the plain version is in kernels.ref)")
    if not 1 <= int(maxval) < 2**16 or not 1 <= n <= 2**32:
        raise ValueError(f"coordinate_delays: maxval {maxval} (1 .. 2^16-1), "
                         f"n {n} (1 .. 2^32)")
    k_hi, k_lo, span, mult = rng.randint_params(key, maxval)
    out = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().coordinate_delays_launch(
            out.data_ptr(), n, k_hi[0], k_hi[1], k_lo[0], k_lo[1], span, mult,
            stream)
    build.check_launch(err, "coordinate_delays")
    coordinate_delays.launches += 1
    return out


coordinate_delays.launches = 0
