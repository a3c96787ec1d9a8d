"""End-to-end training on the PyTorch port: train a ~100M-parameter LM with
async-SGLD (the torch twin of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --mode pipeline
    PYTHONPATH=src python examples/torch_train_lm.py --steps 4 --batch 2 --seq 64 --device cpu

A GPT-small-scale decoder (12L, d=768, 32k vocab ~ 110M params) trained on
the synthetic token stream, with periodic checkpointing (``--ckpt PATH``:
the JAX package's single-model npz, every 100 commits and at the end) and
a final greedy decode through the KV cache (``DecodeEngine``: on a card
the decode kernel, at 3 query heads a KV head).  Modes: sync (paper
baseline) / consistent / inconsistent / pipeline (the overlapped mode);
``--fused`` commits (and in W-Icon mode reads) through the CUDA kernels
on a card.  ``--device cuda`` (the default) needs a card.
"""

import argparse
import time

import numpy as np

from repro_torch.checkpoint import save_checkpoint
from repro_torch.cluster import DecodeEngine
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import SGLDConfig, WorkerModel, simulate_async
from repro_torch.data import make_batch
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, init_params
from repro_torch.train.engine import Engine, checkpoint_hook
from repro_torch.train.loop import make_train_step
from repro_torch.utils import resolve_device, tree_leaves
from repro_torch.weights import drop_unit_chain, unit_chain

LM_100M = ArchConfig(
    name="lm-100m",
    family="dense",
    source="GPT-small scale (example model)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32_000,
    dtype="float32",
    block_pattern=("attn_mlp",),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mode", default="consistent",
                    choices=["sync", "consistent", "inconsistent", "pipeline"])
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--gamma", type=float, default=3e-4)
    ap.add_argument("--sigma", type=float, default=1e-8)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--ckpt", default=None, help="checkpoint path (npz); none by default")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=10, help="commits per engine chunk")
    ap.add_argument("--device", default="cuda", help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LM_100M
    shape = ShapeConfig("lm", seq_len=args.seq, global_batch=args.batch, kind="train")
    model = Model(cfg, device=dev)
    params = unit_chain(init_params(cfg, rng.PRNGKey(0), device=dev))
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params, mode={args.mode}"
          f"{' (fused)' if args.fused else ''}, tokens/step={args.batch * args.seq}, "
          f"device={dev}")

    sgld = SGLDConfig(mode=args.mode, gamma=args.gamma, sigma=args.sigma,
                      tau=args.tau if args.mode in ("consistent", "inconsistent") else 0)
    sampler, _ = make_train_step(model, sgld, fused=args.fused)
    key, init_key = rng.split(rng.PRNGKey(0))
    state = sampler.init(params, init_key)

    delays = None
    if args.mode in ("consistent", "inconsistent"):
        tr = simulate_async(WorkerModel(num_workers=8, seed=0), args.steps, seed=0)
        delays = np.minimum(tr.delays, args.tau)
        print(f"delay trace: mean {tr.mean_delay:.1f} max {tr.max_delay}")

    t0 = time.perf_counter()
    last_log = [-args.log_every]

    def tok_log(step_end, _state, aux):
        if step_end - last_log[0] < args.log_every and step_end != args.steps:
            return
        last_log[0] = step_end
        loss = float(np.asarray(aux["loss"])[-1])
        tps = args.batch * args.seq * step_end / (time.perf_counter() - t0)
        print(f"step {step_end - 1:4d}  loss {loss:7.4f}  {tps:,.0f} tok/s  "
              f"({time.perf_counter() - t0:5.1f}s)", flush=True)

    hooks = [tok_log]
    if args.ckpt:
        hooks.append(checkpoint_hook(args.ckpt, every=100))
    engine = Engine(sampler, batch_fn=lambda k: make_batch(cfg, shape, k, "train"),
                    chunk_size=args.chunk, hooks=hooks)
    state, metrics = engine.run(state, steps=args.steps, delays=delays, key=key)
    losses = np.asarray(metrics["loss"])
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'}); "
          f"{args.steps} commits in {time.perf_counter() - t0:.2f} s")
    if args.ckpt:
        save_checkpoint(args.ckpt, drop_unit_chain(state.params), step=args.steps)
        print("checkpoint:", args.ckpt)

    # decode sanity check: greedy from token 0 through the KV cache
    decoder = DecodeEngine(cfg, state.params, max_seq=16, device=dev)
    sampled = decoder.generate(np.zeros((1, 1), np.int32), 8).tokens[0].tolist()
    print("greedy decode:", sampled)
    return losses, sampled


if __name__ == "__main__":
    main()
