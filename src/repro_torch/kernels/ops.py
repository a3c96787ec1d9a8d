"""Decode steps in model layout (port of ``repro.kernels.ops``'s
``fused_decode_step`` / ``fused_paged_decode_step``).

Dispatch goes by the tensors' device, and nothing else: on a CUDA tensor
the step **is** the hand-written kernel (:mod:`repro_torch.kernels.
decode_step`), which launches or raises — there is no fallback; on a CPU
tensor it is the plain version (:mod:`repro_torch.kernels.ref`).  Either
way the caches / pools are updated in place.
"""

from __future__ import annotations

from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import ref


def _route(t, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no decode step for device {t.device}")


def fused_decode_step(q, k_new, v_new, k_cache, v_cache, valid, slot: int):
    """Ring-cache decode step.

    q: (N, H, hd); k_new, v_new: (N, KV, hd); caches: (N, smax, KV, hd),
    updated in place; valid: (smax,) int32 slot-validity mask (already
    includes the window and the just-written slot); slot: the ring slot of
    the new token.  Returns (o (N, H, hd), k_cache, v_cache).
    """
    N, H, hd = q.shape
    KV = k_cache.shape[2]
    step = _route(q, ds.decode_step, ref.decode_step_ref)
    o, kc, vc = step(q.reshape(N, KV, H // KV, hd), k_new.contiguous(),
                     v_new.contiguous(), k_cache, v_cache, valid, slot)
    return o.reshape(N, H, hd), kc, vc


def fused_paged_decode_step(q, k_new, v_new, k_pages, v_pages, tables, pos):
    """Paged decode step over one page pool per chain.

    q: (C, S, H, hd); k_new, v_new: (C, S, KV, hd); k_pages, v_pages:
    (C, n_pages, page_size, KV, hd), updated in place; tables: (S, maxp)
    int32 per-slot page table, shared by the chains; pos: (S,) int32
    absolute position per slot.  Returns (o (C, S, H, hd), k_pages, v_pages).
    """
    C, S, H, hd = q.shape
    KV = k_pages.shape[3]
    step = _route(q, ds.paged_decode_step, ref.paged_decode_step_ref)
    o, kp, vp = step(q.reshape(C, S, KV, H // KV, hd), k_new.contiguous(),
                     v_new.contiguous(), k_pages, v_pages, tables, pos)
    return o.reshape(C, S, H, hd), kp, vp
