"""Feed-forward blocks: gated (SwiGLU) and plain (port of ``repro.models.mlp``).

Leaves carry the leading axes ``lead`` they are initialised with (chains,
layers); :func:`apply_mlp` takes one layer of a chain bank: weights
``(C, d, f)`` and activations ``(C, ..., d)``.  Under a model axis whose
layout splits the MLP (:class:`~repro_torch.models.common.ModelAxis`),
``w_gate`` / ``w_up`` are the rank's columns and ``w_down`` its rows: the
product is a partial sum, all-reduced over the axis.
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
    act = activation(cfg.act)
    if "w_gate" in params:
        h = act(bank_matmul(x, params["w_gate"])) * bank_matmul(x, params["w_up"])
    else:
        h = act(bank_matmul(x, params["w_up"]))
    y = bank_matmul(h, params["w_down"])
    return tp.all_reduce(y) if tp is not None and tp.mlp else y
