"""Roofline terms of a step against one H100 (port of
``repro.launch.roofline``).

Two terms per (arch x shape), per device of a nominal mesh:

    compute = counted FLOPs per device / the card's peak FLOP rate
    memory  = counted bytes per device / the card's memory rate

The counts come from :func:`repro_torch.launch.flop_cost.step_cost` on
``meta`` tensors.  The reference's third term, collective bytes parsed
from XLA's post-SPMD HLO, and its ``memory_report(compiled)`` have no
counterpart without XLA: memory is the parameter, state and cache bytes of
the ``meta`` tensors (:func:`tree_bytes`), and on the card
``torch.cuda.max_memory_allocated``.

The card's constants are the NVIDIA H100 SXM5 data sheet's (80 GB HBM3,
board power up to 700 W): dense bf16 tensor-core peak 989.4 TFLOP/s (no
sparsity) and 3.35 TB/s of HBM3.  A card run below 700 W (its power limit,
``nvidia-smi --query-gpu=name,power.limit``) may not reach them.  A step's
model FLOPs over its measured wall time and this peak is its ``mfu``.
"""

from __future__ import annotations

from dataclasses import dataclass

CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W (data sheet)"
PEAK_FLOPS = 989.4e12    # dense bf16 tensor-core FLOP/s, one card
HBM_BW = 3.35e12         # bytes/s of HBM3, one card


@dataclass
class Roofline:
    name: str
    flops_per_device: float
    bytes_per_device: float
    t_compute: float
    t_memory: float
    dominant: str
    model_flops_global: float
    counted_flops_global: float
    useful_ratio: float
    card: str = CARD

    def summary(self) -> str:
        return (f"{self.name}: compute {self.t_compute*1e3:.3f}ms, "
                f"memory {self.t_memory*1e3:.3f}ms "
                f"-> {self.dominant}-bound; useful={self.useful_ratio:.2f} "
                f"({self.card})")


def analyze(name: str, cost, num_devices: int,
            model_flops_global: float) -> Roofline:
    """``cost``: a :class:`~repro_torch.launch.flop_cost.Cost` of the whole
    step (global); split evenly over ``num_devices`` cards."""
    n = max(num_devices, 1)
    flops, byts = float(cost.flops) / n, float(cost.bytes) / n
    t_c, t_m = flops / PEAK_FLOPS, byts / HBM_BW
    return Roofline(
        name=name, flops_per_device=flops, bytes_per_device=byts,
        t_compute=t_c, t_memory=t_m,
        dominant="compute" if t_c >= t_m else "memory",
        model_flops_global=model_flops_global,
        counted_flops_global=float(cost.flops),
        useful_ratio=(model_flops_global / float(cost.flops)) if cost.flops else 0.0)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only (N = active
    params, D = global tokens processed by the step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens


def mfu(model_flops_step: float, step_seconds: float, num_devices: int = 1) -> float:
    """Model-FLOPs share of a whole step: its model FLOPs over its measured
    wall seconds and the peak of ``num_devices`` cards."""
    return model_flops_step / (step_seconds * PEAK_FLOPS * max(num_devices, 1))


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (``meta`` tensors included)."""
    import torch

    from repro_torch.analysis.cost import tensor_leaves

    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree)
               if torch.is_tensor(t))
