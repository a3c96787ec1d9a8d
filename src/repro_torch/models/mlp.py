"""Feed-forward blocks: gated (SwiGLU) and plain (port of ``repro.models.mlp``).

Leaves carry the leading axes ``lead`` they are initialised with (chains,
layers); :func:`apply_mlp` takes one layer of a chain bank: weights
``(C, d, f)`` and activations ``(C, ..., d)``.  Under a model axis whose
layout splits the MLP (:class:`~repro_torch.models.common.ModelAxis`),
``w_gate`` / ``w_up`` are the rank's columns and ``w_down`` its rows: the
input enters through ``copy_to`` (its gradient summed over the axis) and
the product, a partial sum, leaves through ``reduce_from``.
"""

from __future__ import annotations

from repro_torch.models.common import activation, bank_matmul, dense_init


def init_mlp(generator, cfg, dtype, lead=(), device="cpu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    names = ("w_up", "w_down") if cfg.act == "gelu" else ("w_gate", "w_up", "w_down")
    return {n: dense_init(generator, lead + ((f, d) if n == "w_down" else (d, f)),
                          dtype, device=device)
            for n in names}


def apply_mlp(params: dict, x, cfg, tp=None):
    split = tp is not None and tp.mlp
    if split:
        x = tp.copy_to(x)
    act = activation(cfg.act)
    if "w_gate" in params:
        h = act(bank_matmul(x, params["w_gate"])) * bank_matmul(x, params["w_up"])
    else:
        h = act(bank_matmul(x, params["w_up"]))
    y = bank_matmul(h, params["w_down"])
    return tp.reduce_from(y) if split else y
