"""xLSTM blocks over a chain bank: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential) [arXiv:2405.04517] (port
of ``repro.models.xlstm``).

The mLSTM recurrence ``C_t = f_t C_{t-1} + i_t k_t v_t^T`` runs chunkwise:
within a chunk the work is matmul-shaped, and only the carry between
chunks is sequential (a Python loop over ``S / chunk`` chunks, as the
reference's ``lax.scan``).  The exponential gating is stabilised in log
space with a carried max-state ``m``.  The sLSTM feeds ``h_{t-1}`` through
its recurrent weights, so it is a Python loop over the sequence.  The
reference computes both in plain ``jnp``, outside any Pallas kernel; here
they are plain torch.

Parameters carry the chain axis ``(C, ...)``, activations are ``(C, B, S,
d)``.  Past the projections the mLSTM chunks have no parameters, so chains
and rows fold into one batch axis of ``C * B``; the sLSTM's recurrent
weights are per chain, ``(C, H, dh, 4 dh)``.

mLSTM state a head: C ``(dk, dv)``, n ``(dk,)``, m a scalar.  sLSTM state a
unit: c, n, m, h.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    activation,
    bank_matmul,
    dense_init,
    per_chain,
    repeat_lead,
    rms_norm,
)

NEG = -1e30


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``linspace`` in float32.  XLA's CPU code for ``jnp.linspace`` fuses
    its multiply-adds differently with the length, so at 256 and 2,048
    values it is within one ulp of this one, not equal (at the mLSTM's
    head counts the two are equal)."""
    return torch.linspace(start, stop, num, dtype=torch.float32)


# ===========================================================================
# mLSTM
# ===========================================================================
def init_mlstm(generator, cfg, dtype, lead=(), device="cpu") -> dict:
    d = cfg.d_model
    di = 2 * d  # pre-up-projection factor 2
    H = cfg.num_heads
    dk = di // H
    lead = tuple(lead)
    dev = torch.device(device)

    def headmat():  # block-diagonal per-head projection
        return dense_init(generator, lead + (H, dk, dk), dtype, scale=1.0 / math.sqrt(dk),
                          device=dev)

    gates_b = torch.cat([torch.zeros(H),              # input gate bias
                         _linspace(3.0, 6.0, H)])     # forget bias (high)
    return {
        "in_proj": dense_init(generator, lead + (d, 2 * di), dtype, device=dev),
        "wq": headmat(),
        "wk": headmat(),
        "wv": headmat(),
        "gates": dense_init(generator, lead + (di, 2 * H), dtype, device=dev),
        "gates_b": repeat_lead(gates_b, lead, dev),
        "norm": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, lead + (di, d), dtype, device=dev),
        "skip": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (C, B, H, dk, dv) float32
    n: torch.Tensor  # (C, B, H, dk) float32
    m: torch.Tensor  # (C, B, H) float32 stabiliser


def init_mlstm_state(cfg, batch: int, lead, device="cpu") -> MLSTMState:
    """Zero state for ``batch`` rows; ``lead`` are the axes before the rows
    (the chains)."""
    di = 2 * cfg.d_model
    H = cfg.num_heads
    dk = di // H
    lead = tuple(lead) + (batch, H)
    return MLSTMState(
        c=torch.zeros(lead + (dk, dk), dtype=torch.float32, device=device),
        n=torch.zeros(lead + (dk,), dtype=torch.float32, device=device),
        m=torch.zeros(lead, dtype=torch.float32, device=device),
    )


def _mlstm_chunk(q, k, v, lf, li, chunk: int, state: MLSTMState):
    """Chunkwise stabilised mLSTM.

    q, k, v: (N, S, H, dk) float32; lf: (N, S, H) log forget gate
    (log-sigmoid); li: (N, S, H) input gate pre-activation (log space);
    state: (N, H, dk, dv), (N, H, dk), (N, H).  Returns y: (N, S, H, dk)
    and the final state."""
    N, S, H, dk = q.shape
    c = min(chunk, S)
    assert S % c == 0, f"seq {S} not divisible by mlstm chunk {c}"
    rs = math.sqrt(dk)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device))
    C, n, m = state
    ys = []
    for j in range(S // c):
        sl = slice(j * c, (j + 1) * c)
        qb, kb, vb, lib = q[:, sl], k[:, sl], v[:, sl], li[:, sl]
        seg = torch.cumsum(lf[:, sl], dim=1)  # (N, c, H)
        # log weight of source s seen at target t: seg_t - seg_s + li_s
        logw = seg[:, :, None, :] - seg[:, None, :, :] + lib[:, None, :, :]
        logw = torch.where(tri[None, :, :, None], logw, NEG)  # (N, t, s, H)
        # the inter-chunk contribution enters with log weight seg_t + m
        log_inter = seg + m[:, None, :]  # (N, c, H)
        m_t = torch.maximum(logw.amax(dim=2), log_inter)  # stabiliser per t
        w = torch.exp(logw - m_t[:, :, None, :])  # (N, t, s, H)
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) / rs
        sw = scores * w
        num_intra = torch.einsum("btsh,bshd->bthd", sw, vb)
        den_intra = sw.sum(dim=2)
        inter_scale = torch.exp(log_inter - m_t)  # (N, c, H)
        num_inter = torch.einsum("bthd,bhde->bthe", qb, C) * inter_scale[..., None] / rs
        den_inter = torch.einsum("bthd,bhd->bth", qb, n) * inter_scale / rs
        num = num_intra + num_inter
        den = den_intra + den_inter
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state at the chunk's end
        seg_end = seg[:, -1, :]  # (N, H)
        m_new = torch.maximum(seg_end + m,
                              (seg_end[:, None, :] - seg + lib).amax(dim=1))
        w_end = torch.exp(seg_end[:, None, :] - seg + lib - m_new[:, None, :])  # (N, c, H)
        carry = torch.exp(seg_end + m - m_new)  # (N, H)
        C = (carry[:, :, None, None] * C
             + torch.einsum("bchd,bche->bhde", w_end[..., None] * kb, vb))
        n = carry[:, :, None] * n + torch.einsum("bch,bchd->bhd", w_end, kb)
        m = m_new
    return torch.cat(ys, dim=1), MLSTMState(c=C, n=n, m=m)


def apply_mlstm(params, x, cfg, *, chunk: int = 64, state: MLSTMState | None = None):
    """x: (C, B, S, d) -> (C, B, S, d); with ``state`` (decode: chunk 1)
    also the new state."""
    Cc, B, S, d = x.shape
    di = 2 * d
    H = cfg.num_heads
    dk = di // H

    xi, z = bank_matmul(x, params["in_proj"]).chunk(2, dim=-1)
    xh = xi.reshape(Cc, B, S, H, dk)
    q, k, v = (torch.einsum("cbshd,chde->cbshe", xh, params[w]).float()
               .reshape(Cc * B, S, H, dk) for w in ("wq", "wk", "wv"))
    gates = (bank_matmul(xi, params["gates"]).float()
             + per_chain(params["gates_b"], xi))
    li, lf_pre = gates.reshape(Cc * B, S, 2 * H).chunk(2, dim=-1)  # (N, S, H) each
    lf = F.logsigmoid(lf_pre)

    st = state if state is not None else init_mlstm_state(cfg, B, (Cc,), x.device)
    st = MLSTMState(*(t.reshape(Cc * B, *t.shape[2:]) for t in st))
    y, new = _mlstm_chunk(q, k, v, lf, li, chunk if state is None else 1, st)
    y = y.reshape(Cc, B, S, di).to(x.dtype)
    y = y + per_chain(params["skip"], y).to(x.dtype) * xi
    y = rms_norm(y * F.silu(z), per_chain(params["norm"], y), cfg.norm_eps)
    out = bank_matmul(y, params["out_proj"])
    if state is None:
        return out
    return out, MLSTMState(*(t.reshape(Cc, B, *t.shape[1:]) for t in new))


# ===========================================================================
# sLSTM
# ===========================================================================
def init_slstm(generator, cfg, dtype, lead=(), device="cpu") -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    f = int(d * 4 / 3)
    lead = tuple(lead)
    dev = torch.device(device)
    bias = torch.cat([torch.zeros(d),               # i
                      _linspace(3.0, 6.0, d),       # f (high forget bias)
                      torch.zeros(2 * d)])          # z, o
    return {
        "wx": dense_init(generator, lead + (d, 4 * d), dtype, device=dev),
        "wr": dense_init(generator, lead + (H, dh, 4 * dh), dtype, scale=1.0 / math.sqrt(dh),
                         device=dev),
        "bias": repeat_lead(bias, lead, dev),
        "ffn_up": dense_init(generator, lead + (d, 2 * f), dtype, device=dev),
        "ffn_down": dense_init(generator, lead + (f, d), dtype, device=dev),
        "norm": torch.ones(lead + (d,), dtype=torch.float32, device=dev),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (C, B, d)
    n: torch.Tensor  # (C, B, d)
    m: torch.Tensor  # (C, B, d)
    h: torch.Tensor  # (C, B, d)


def init_slstm_state(cfg, batch: int, lead, device="cpu") -> SLSTMState:
    """The initial state for ``batch`` rows (n starts at 1e-6, as in the
    reference); ``lead`` are the axes before the rows (the chains)."""
    z = torch.zeros(tuple(lead) + (batch, cfg.d_model), dtype=torch.float32,
                    device=device)
    return SLSTMState(c=z, n=z + 1e-6, m=z.clone(), h=z.clone())


def _slstm_cell(params, cfg, xt, st: SLSTMState) -> SLSTMState:
    """One step: xt (C, B, 4d), the pre-projected gate inputs."""
    C, B = xt.shape[:2]
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    hr = st.h.reshape(C, B, H, dh)
    rec = torch.einsum("cbhd,chde->cbhe", hr, params["wr"].float())
    # per head (4 dh) -> gate-major: i, f, z, o each (d,)
    rec = rec.reshape(C, B, H, 4, dh).transpose(2, 3).reshape(C, B, 4 * d)
    pre = xt.float() + rec + per_chain(params["bias"], rec)
    i_pre, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
    m_new = torch.maximum(f_pre + st.m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + st.m - m_new)
    z_g = torch.tanh(z_pre)
    o_g = torch.sigmoid(o_pre)
    c_new = f_g * st.c + i_g * z_g
    n_new = f_g * st.n + i_g
    h_new = o_g * c_new / torch.clamp_min(n_new, 1e-6)
    return SLSTMState(c=c_new, n=n_new, m=m_new, h=h_new)


def apply_slstm(params, x, cfg, *, state: SLSTMState | None = None):
    """x: (C, B, S, d) -> (C, B, S, d); with ``state`` also the new state.
    The time loop is one Python step a position."""
    C, B, S, d = x.shape
    xg = bank_matmul(x, params["wx"])  # (C, B, S, 4d)
    st = state if state is not None else init_slstm_state(cfg, B, (C,), x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(params, cfg, xg[:, :, t], st)
        hs.append(st.h)
    y = torch.stack(hs, dim=2).to(x.dtype)  # (C, B, S, d)
    y = rms_norm(y, per_chain(params["norm"], y), cfg.norm_eps)
    a, b = bank_matmul(y, params["ffn_up"]).chunk(2, dim=-1)
    out = bank_matmul(activation("gelu")(a) * b, params["ffn_down"])
    if state is None:
        return out
    return out, st
