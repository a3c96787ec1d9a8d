"""How far a model's gradient moves under a reorder of its sums alone, and
how far one ulp of its weights moves it: the unplaced gradient of one batch
taken in one microbatch and in two (the same mean, summed in another
order), leaf by leaf, on one card, beside the one-microbatch gradient at
weights moved by one ulp each (up or down at random) and the same
gradient taken twice; in bf16 also how far it is from the float32
gradient at the same weights.

A placed step's gradient is held against the unplaced one's
(``chip_smoke.py`` phase 15); this is the floor under any such gate. Where
the one-ulp move carries the gradient as far as the reorder does, rounding,
amplified by the model, accounts for the reorder's spread. Usage::

    python3 scripts/torch_grad_spread.py [--cells xlstm-1.3b:8 hymba-1.5b:2 qwen3-4b:4]
        [--dtypes bfloat16 float32] [--device cuda] [--reduced] [--batch 8 --seq 128]

``--reduced`` takes each config's reduced widths and layers (the CPU
rehearsal's, ``tests/torch_model_axis_train_world.py``; a cell's layers
are then ignored).

Prints the card's name and power limit, then one JSON line a (config,
dtype): the two losses and, for each of ``reorder`` (one microbatch
against two), ``ulp`` (the weights moved by one ulp against not) and
``repeat`` (the same call twice) and, below float32, ``vs_float32`` (the
float32 gradient at the same weights against this one), each leaf's
relative L2 between the two gradients (the largest, the median, the six
largest); and the largest |gradient|. The batch is ``batch`` x ``seq + 1``
tokens from ``numpy.random.default_rng(5)``;
the weights are ``init_params`` from seed 0, the ulp's directions from
seed 1. Imports no JAX.
"""

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _spread(np, leaf_paths, ref, other) -> dict:
    """Each leaf's relative L2 of ``other`` from ``ref`` (in float64): the
    largest, the median and the six largest."""
    rel = {p: float((b.double() - a.double()).norm() / a.double().norm().clamp_min(1e-30))
           for (p, a), (_, b) in zip(leaf_paths(ref), leaf_paths(other))}
    return {"max_rel": max(rel.values()), "median_rel": float(np.median(list(rel.values()))),
            "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:6]}


def _one_ulp(torch, tree_map, params, device):
    """``params`` with each floating element moved by one ulp, up or down at
    random (seed 1)."""
    gen = torch.Generator(device=device).manual_seed(1)

    def move(t):
        if not t.is_floating_point():
            return t
        up = torch.randint(0, 2, t.shape, generator=gen, device=t.device, dtype=torch.bool)
        inf = torch.tensor(float("inf"), dtype=t.dtype, device=t.device)
        return torch.nextafter(t, torch.where(up, inf, -inf))

    return tree_map(move, params)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=["xlstm-1.3b:8", "hymba-1.5b:2",
                                                   "qwen3-4b:4"],
                    help="ARCH:LAYERS, each at its published widths")
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced widths and layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.checkpoint.io import leaf_paths
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.train.loop import make_grad_fn
    from repro_torch.utils import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    for cell in args.cells:
        arch, _, layers = cell.partition(":")
        for dtype in args.dtypes:
            t0 = time.perf_counter()
            cfg = (replace(get_reduced(arch), dtype=dtype) if args.reduced
                   else replace(get_arch(arch), num_layers=int(layers), dtype=dtype))
            params = init_params(cfg, 0, device=args.device, num_chains=1)
            tokens = torch.from_numpy(np.random.default_rng(5).integers(
                0, cfg.vocab_size, (args.batch, args.seq + 1)))
            model = Model(cfg, device=args.device)
            g1, m1 = make_grad_fn(model, 1)(params, {"tokens": tokens})
            g2, m2 = make_grad_fn(model, 2)(params, {"tokens": tokens})
            again = make_grad_fn(model, 1)(params, {"tokens": tokens})[0]
            moved = _one_ulp(torch, tree_map, params, args.device)
            g_ulp = make_grad_fn(model, 1)(moved, {"tokens": tokens})[0]
            del moved
            pairs = [("reorder", g2), ("ulp", g_ulp), ("repeat", again)]
            if dtype != "float32":
                f32 = replace(cfg, dtype="float32")
                pairs.append(("vs_float32", make_grad_fn(Model(f32, device=args.device), 1)(
                    tree_map(lambda t: t.float() if t.is_floating_point() else t, params),
                    {"tokens": tokens})[0]))
            print(json.dumps({
                "arch": arch, "layers": cfg.num_layers, "dtype": dtype,
                "loss": [float(m1["loss"]), float(m2["loss"])],
                **{name: _spread(np, leaf_paths, g1, g) for name, g in pairs},
                "max_abs_grad": max(float(t.abs().max()) for _, t in leaf_paths(g1)),
                "seconds": time.perf_counter() - t0}), flush=True)
            del params, g1, g2, again, g_ulp, model, pairs
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
