"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode (the torch twin of ``examples/serve_batch.py``).

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cuda]
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu --tokens 4 --warm-steps 2

Posterior-sampled weights (a few fused async-SGLD commits of the reduced
qwen3-4b, a chain bank of ``--chains``) -> the prompt batch's next-token
law through ``ServeEngine`` (every chain's ``Model.prefill``, then the
Bayesian model average with its credible intervals) -> greedy decode of
``--tokens`` tokens through ``ServeEngine.decoder`` (the ring KV cache; on
a card the decode kernel), reporting the prefill's and the decode's
latency.  The decoder's first token is the argmax of the BMA law of the
same prefill.  ``--device cuda`` (the default) needs a card.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.cluster import ServeEngine
from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.core import SGLDConfig
from repro_torch.data import make_batch
from repro_torch.kernels import rng
from repro_torch.models import bma_logits, transformer_next_token_predict
from repro_torch.models.transformer import Model, init_params
from repro_torch.train.engine import Engine
from repro_torch.train.loop import make_train_step
from repro_torch.utils import resolve_device, tree_map
from repro_torch.weights import unit_chain


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--warm-steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    cfg = get_reduced(args.arch)
    if cfg.block_pattern[0] not in ("attn_mlp", "attn_moe"):
        raise SystemExit(f"{args.arch}: prefill->cache path is attention-only; "
                         "recurrent archs serve via init_cache + replay")
    model = Model(cfg, device=dev)
    chains = []
    # a few fused SGLD commits a chain, so the served weights are posterior
    # samples (each chain from its own draw and key)
    shape = ShapeConfig("warm", seq_len=64, global_batch=2, kind="train")
    sampler, _ = make_train_step(model, SGLDConfig(mode="pipeline", gamma=1e-3, sigma=1e-8),
                                 fused=True)
    for c in range(args.chains):
        params = unit_chain(init_params(cfg, rng.PRNGKey(c), device=dev))
        if args.warm_steps > 0:
            key, init_key = rng.split(rng.PRNGKey(c))
            engine = Engine(sampler, batch_fn=lambda k: make_batch(cfg, shape, k, "train"),
                            chunk_size=args.warm_steps)
            state, _ = engine.run(sampler.init(params, init_key), steps=args.warm_steps,
                                  key=key)
            params = state.params
        chains.append(params)
    bank = tree_map(lambda *xs: torch.cat(xs), *chains)  # (C, ...)
    serve = ServeEngine(predict_fn=transformer_next_token_predict(model), params=bank,
                        device=dev)

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    sync()
    t0 = time.perf_counter()
    res = serve({"tokens": prompts})  # (B, V) per-chain logits' statistics
    prefill_s = time.perf_counter() - t0
    with torch.no_grad():
        per_chain = transformer_next_token_predict(model)(bank, {"tokens": prompts})
        first = bma_logits(per_chain).argmax(dim=-1).cpu().numpy()
    print(f"prefill {args.batch}x{args.prompt_len} over {serve.num_chains} chains: "
          f"{prefill_s:.3f} s; mean next-token logit spread (90% interval) "
          f"{float(np.mean(res.quantiles[-1] - res.quantiles[0])):.4f}")

    decoder = serve.decoder(model, max_seq=args.prompt_len + args.tokens)
    decoder.generate(prompts, 2)  # warm-up: allocator, library handles
    sync()
    t0 = time.perf_counter()
    gen = decoder.generate(prompts, args.tokens).tokens
    decode_s = time.perf_counter() - t0
    if not np.array_equal(gen[:, 0], first):
        raise SystemExit(f"the decoder's first tokens {gen[:, 0]} are not the BMA "
                         f"argmax of the prefill {first}")
    print(f"decode: {decode_s * 1e3 / args.tokens:.2f} ms/token over "
          f"{args.tokens} tokens (one generate call, prefill included)")
    for b in range(args.batch):
        print(f"  seq{b}: {[int(x) for x in gen[b][:10]]}...")
    return gen


if __name__ == "__main__":
    main()
