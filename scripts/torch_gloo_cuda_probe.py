#!/usr/bin/env python3
"""Which collectives a gloo world of two ranks on one card takes on CUDA
tensors, and what they cost: the world ``chip_smoke.py``'s phase 14 runs
the model axis in (``repro_torch.launch.mesh.init_world("cuda",
backend="gloo")``; NCCL refuses two ranks on one device).

    python3 scripts/torch_gloo_cuda_probe.py

Three worlds of two processes each, one after the other, each rank
printing a line a step (a crash ends only its own world): (1) all-reduce,
all-gather and broadcast of float32 and bfloat16 CUDA tensors on the
default group, then the ms of an all-reduce of a 4 x 4 x 2,560 block (one
decode step's activations of qwen3-4b's 4-chain bank, 4 rows) and of an
all-gather of a 4 x 4 x 75,968 block (a rank's half of its logits), each
averaged over repeats; (2) a ``DeviceMesh("cuda")`` over the two ranks:
an all-reduce on its ``model`` group, then a ``DTensor``'s
``full_tensor``; (3) the same on a ``DeviceMesh("cpu")`` holding CUDA
tensors.  Needs one card; imports only torch.
"""

import datetime
import os
import subprocess
import sys
import tempfile
import time


def say(rank, *parts):
    print(f"[rank {rank} {time.perf_counter():.1f} s]", *parts, flush=True)


def rank_main(rank: int, store: str, variant: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(rank)

    def attempt(name, fn):
        try:
            say(rank, name, "->", fn())
        except Exception as e:  # noqa: BLE001 — the probe reports what gloo refuses
            say(rank, name, f"refused: {type(e).__name__}: {str(e)[:300]}")

    def timed(fn, t, repeats):
        for _ in range(3):
            fn(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / repeats * 1e3

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    if variant == "collectives":
        for dt in (torch.float32, torch.bfloat16):
            def reduce(dt=dt):
                t = torch.full((4,), float(rank + 1), device=dev, dtype=dt)
                dist.all_reduce(t)
                return t.float().tolist()

            def bcast(dt=dt):
                t = torch.full((2,), float(rank + 1), device=dev, dtype=dt)
                dist.broadcast(t, src=0)
                return t.float().tolist()

            attempt(f"all_reduce {dt}", reduce)
            attempt(f"all_gather {dt}", lambda dt=dt: gather(
                torch.full((2,), float(rank + 1), device=dev, dtype=dt)).float().tolist())
            attempt(f"broadcast {dt}", bcast)
        for dt in (torch.float32, torch.bfloat16):
            attempt(f"all_reduce ms, 4 x 4 x 2560 {dt}", lambda dt=dt: timed(
                dist.all_reduce,
                torch.randn(4, 4, 2560, device=dev, generator=gen).to(dt), 50))
            attempt(f"all_gather ms, 4 x 4 x 75968 {dt}", lambda dt=dt: timed(
                gather, torch.randn(4, 4, 75968, device=dev, generator=gen).to(dt), 10))
    else:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = DeviceMesh(variant, torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")

        def group_reduce():
            x = torch.ones(3, device=dev)
            dist.all_reduce(x, group=group)
            return x.tolist()

        def full():
            t = torch.full((2, 3), float(rank), device=dev)
            return DTensor.from_local(t, mesh, [Replicate(), Shard(1)],
                                      run_check=False).full_tensor().tolist()

        attempt(f"DeviceMesh({variant!r}) model-group all_reduce", group_reduce)
        attempt(f"DeviceMesh({variant!r}) DTensor full_tensor", full)
    dist.destroy_process_group()
    say(rank, "done")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for variant in ("collectives", "cuda", "cpu"):
        with tempfile.TemporaryDirectory() as d:
            logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(2)]
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                       os.path.join(d, "store"), variant],
                                      stdout=logs[r], stderr=subprocess.STDOUT)
                     for r in range(2)]
            codes = []
            for p in procs:
                try:
                    codes.append(p.wait(timeout=120))
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes.append("killed at 120 s")
            print(f"== {variant}: exit codes {codes}", flush=True)
            for r, f in enumerate(logs):
                f.close()
                print(open(os.path.join(d, f"rank{r}.log")).read()[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
