"""Roofline terms of a step against the H100 (port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), per device:

    compute    = counted FLOPs per device / the card's peak FLOP rate
    memory     = counted bytes per device / the card's memory rate
    collective = collective bytes per device / the link rate

The counts come from :func:`repro_torch.launch.flop_cost.step_cost` on
``meta`` tensors: of the whole step on one card, or of rank 0's placed
step on a mesh (:mod:`repro_torch.launch.dryrun`, in a fake world), whose
collective bytes are what the port's collective helpers send
(:data:`repro_torch.models.common.TRAFFIC`: an all-reduce's buffer, an
all-gather's result, the reference's per-device result-buffer bytes).
The reference parses XLA's post-SPMD HLO for them and reads
``memory_report(compiled)``; without XLA, memory is the parameter, state,
cache and batch bytes of the rank's ``meta`` blocks (:func:`tree_bytes`),
and on the card ``torch.cuda.max_memory_allocated``.

The card's constants are the NVIDIA H100 SXM5 data sheet's (80 GB HBM3,
board power up to 700 W): dense bf16 tensor-core peak 989.4 TFLOP/s (no
sparsity) and 3.35 TB/s of HBM3.  A card run below 700 W (its power limit,
``nvidia-smi --query-gpu=name,power.limit``) may not reach them.  The link
rates are data-sheet figures too, not measured (no multi-card run exists
yet): NVLink 4 within a node of 8 cards, 450 GB/s each way a card (18
links; "900 GB/s" counts both ways), and between nodes one 400 Gb/s NDR
InfiniBand port a card, 50 GB/s (the DGX H100's eight ConnectX-7); a mesh
of more than 8 cards is bounded by the second.  A step's model FLOPs over
its measured wall time and the peak is its ``mfu``.
"""

from __future__ import annotations

from dataclasses import dataclass

CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W (data sheet)"
PEAK_FLOPS = 989.4e12    # dense bf16 tensor-core FLOP/s, one card
HBM_BW = 3.35e12         # bytes/s of HBM3, one card
NVLINK_BW = 450e9        # bytes/s each way a card, NVLink 4 (data sheet)
IB_BW = 50e9             # bytes/s a card between nodes, NDR 400 Gb/s (data sheet)
NODE_CARDS = 8           # cards a node's NVLink joins


def link(num_devices: int) -> tuple:
    """``(bytes/s, name)`` of the link a mesh of ``num_devices`` cards is
    bounded by: NVLink within one node, InfiniBand across nodes."""
    if num_devices <= NODE_CARDS:
        return NVLINK_BW, "NVLink 4, 450 GB/s each way (data sheet)"
    return IB_BW, "InfiniBand NDR 400 Gb/s a card (data sheet)"


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
    collective_bytes_per_device: float = 0.0
    t_collective: float = 0.0
    link: str = ""
    card: str = CARD

    def summary(self) -> str:
        return (f"{self.name}: compute {self.t_compute*1e3:.3f}ms, "
                f"memory {self.t_memory*1e3:.3f}ms, "
                f"collective {self.t_collective*1e3:.3f}ms "
                f"-> {self.dominant}-bound; useful={self.useful_ratio:.2f} "
                f"({self.card})")


def analyze(name: str, cost, model_flops_global: float, num_devices: int = 1,
            collective_bytes: float = 0.0) -> Roofline:
    """``cost``: a :class:`~repro_torch.launch.flop_cost.Cost` of one
    device's step (the whole step on one card, rank 0's on a mesh of
    ``num_devices``); ``collective_bytes``: what that device's collectives
    moved.  The global counted FLOPs are the device's times the mesh's
    size (rank 0 stands for every rank)."""
    n = max(num_devices, 1)
    flops, byts = float(cost.flops), float(cost.bytes)
    rate, link_name = link(n)
    t_c, t_m = flops / PEAK_FLOPS, byts / HBM_BW
    t_x = float(collective_bytes) / rate if n > 1 else 0.0
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return Roofline(
        name=name, flops_per_device=flops, bytes_per_device=byts,
        t_compute=t_c, t_memory=t_m, dominant=max(terms, key=terms.get),
        model_flops_global=model_flops_global,
        counted_flops_global=flops * n,
        useful_ratio=(model_flops_global / (flops * n)) if flops else 0.0,
        collective_bytes_per_device=float(collective_bytes), t_collective=t_x,
        link=link_name if n > 1 else "")


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
