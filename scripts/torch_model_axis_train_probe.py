#!/usr/bin/env python3
"""Where a placed training step's time goes on one card: the step of
``chip_smoke.py`` phase 15 (a) — qwen3-4b at its widths and 4 layers in
bf16, a global batch of 8 x 128 tokens in 2 microbatches, a world of 4
gloo ranks on the card (``data`` 2 x ``model`` 2) — cut into its parts.

    python3 scripts/torch_model_axis_train_probe.py [--layers 4] [--steps 3]
        [--chunks 1048576 4194304 ...] [--chunk N]

First, in this process: the ms of ``rng.jax_normal`` (the ``"jax"``
noise, int32 threefry) over 2**27 elements against the same draw through
the int64 threefry of ``rng.random_bits``, the two bit for bit, and the
draw's ms in slices of each ``--chunks`` size (``rng.CHUNK``; ``--chunk``
sets it in the world).  Then
the world, each rank printing per step: the ms of the placed gradient
function (its forward and backward, and inside it the data mean and model
sums of ``_reduce_placed``), of the rank's block of the noise, of the
update, and of the whole ``sync`` step; an all-reduce over ``data`` and an
all-gather over ``model`` of a rank's gradient block, each timed alone.
Needs one card; imports only torch, numpy and ``repro_torch``.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def say(rank, *parts):
    print(f"[rank {rank}]", *parts, flush=True)


def _ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def draws(chunks) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import rng

    dev = torch.device("cuda", 0)
    n, key = 2**27, rng.PRNGKey(7)
    rng.jax_normal(key, (2**20,), dev)  # warm
    default = rng.CHUNK
    for c in chunks:
        rng.CHUNK = c
        _, ms = _ms(torch, lambda: rng.jax_normal(key, (n,), dev))
        print(f"jax_normal of {n} elements in slices of {c}: {ms:.1f} ms "
              f"({ms * 1e6 / n:.3f} ns an element)", flush=True)
    rng.CHUNK = default

    def int64_draw():
        out = torch.empty(n, dtype=torch.float32, device=dev)
        lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
        for a in range(0, n, rng.CHUNK):
            b = min(n, a + rng.CHUNK)
            bits = rng.random_bits(key, b - a, dev, start=a).to(torch.int32)
            u = rng._uniform_values(bits, lo, 1.0)
            out[a:b] = (2.0 ** 0.5) * rng._xla_erf_inv(u)
        return out

    z32, ms32 = _ms(torch, lambda: rng.jax_normal(key, (n,), dev))
    z64, ms64 = _ms(torch, int64_draw)
    print(f"jax_normal of {n} elements: int32 threefry {ms32:.1f} ms "
          f"({ms32 * 1e6 / n:.3f} ns an element), int64 {ms64:.1f} ms "
          f"({ms64 * 1e6 / n:.3f}); the same bits: {torch.equal(z32, z64)}", flush=True)


def rank_main(rank: int, store: str, layers: int, steps: int, chunk: int) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import rng
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.launch.steps import make_sgld_train_step, place_params
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.samplers.transforms import noise_like, sgld_apply
    from repro_torch.train import loop
    from repro_torch.utils import all_gather, local, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    rng.CHUNK = chunk
    init_world("cuda", store, rank=rank, world_size=4, backend="gloo")
    mesh = make_debug_mesh(2, 2)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = replace(get_arch("qwen3-4b"), num_layers=layers, dtype="bfloat16")
    shape = ShapeConfig("probe", 128, 8, "train", num_microbatches=2)
    whole = init_params(cfg, 0, device=dev, num_chains=1)
    model = Model(cfg, device=dev, mesh=mesh, batch_axes=("data",))
    params = place_params(whole, model)
    del whole
    torch.cuda.empty_cache()
    grad_fn = loop.make_grad_fn(model, 2)
    step = make_sgld_train_step(model, shape, "sync", 1e-3, 1e-5)
    reduce_ms = []
    inner = loop._reduce_placed

    def timed_reduce(*a):
        out, ms = _ms(torch, lambda: inner(*a))
        reduce_ms.append(ms)
        return out

    loop._reduce_placed = timed_reduce
    r = np.random.default_rng(5)
    for i in range(steps):
        tokens = torch.from_numpy(r.integers(0, cfg.vocab_size, (8, 129)).astype(np.int32))
        key = rng.PRNGKey(100 + i)
        (grads, _), g_ms = _ms(torch, lambda: grad_fn(params, {"tokens": tokens}))
        z, z_ms = _ms(torch, lambda: noise_like(key, params, 1.4e-4, torch.float32, "jax"))
        _, u_ms = _ms(torch, lambda: sgld_apply(local(params), local(grads), 1e-3, local(z)))
        del grads, z
        _, s_ms = _ms(torch, lambda: step(params, {"tokens": tokens}, key))
        say(rank, f"step {i}: gradient {g_ms:.1f} ms (of it the data mean and model sums "
            f"{reduce_ms[-1]:.1f}), noise {z_ms:.1f}, update {u_ms:.1f}; the sync step "
            f"{s_ms:.1f} ms")
    block = sum(t.to_local().numel() for t in tree_leaves(params))
    t = torch.zeros(block, dtype=torch.bfloat16, device=dev)
    import torch.distributed as dist

    for name, fn in (("all-reduce over data", lambda: dist.all_reduce(
                         t, group=mesh.get_group("data"))),
                     ("all-gather over model", lambda: all_gather(
                         t, mesh.get_group("model"), 0))):
        _ms(torch, fn)
        _, ms = _ms(torch, fn)
        say(rank, f"{name} of a {block}-element bf16 block ({block * 2 / 1e9:.2f} GB): "
            f"{ms:.1f} ms")
    dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--store", default=None)
    p.add_argument("--chunk", type=int, default=None,
                   help="rng.CHUNK in the world (default: the module's)")
    p.add_argument("--chunks", type=int, nargs="*", default=[],
                   help="slice sizes to time the draw at, in this process")
    a = p.parse_args()
    if a.chunk is None:
        from repro_torch.kernels import rng

        a.chunk = rng.CHUNK
    if a.rank is not None:
        rank_main(a.rank, a.store, a.layers, a.steps, a.chunk)
        return 0
    draws(a.chunks)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                   str(r), "--store", os.path.join(tmp, "store"),
                                   "--layers", str(a.layers), "--steps", str(a.steps),
                                   "--chunk", str(a.chunk)])
                 for r in range(4)]
        codes = [q.wait(timeout=900) for q in procs]
    print("exit codes", codes, flush=True)
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
