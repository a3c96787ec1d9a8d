"""Paper §3.3 reproduction on the PyTorch port: Reconstruction ICA under
async SGLD.

    PYTHONPATH=src python examples/torch_rica_patches.py [--P 4] [--nu 0.01] [--device cuda]

``--device cuda`` (the default) runs the chains on a GPU; ``--device cpu``
runs the plain PyTorch path.
The paper ran RICA on CIFAR-10 patches on a GPU with MPS concurrency
(P in {2,4,8}); offline we use seeded 1/f synthetic patches and the M2-like
worker model (DESIGN.md §2).  Prints the objective / distance-to-optimum
table and saves the figure if matplotlib is present.
"""

import argparse
import os

from repro_torch.experiments import run_rica_experiment


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--P", type=int, default=4)
    ap.add_argument("--nu", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    res = run_rica_experiment(P=args.P, nu=args.nu, steps=args.steps,
                              device=args.device)
    label = {"sync": "Sync", "consistent": "W-Con", "inconsistent": "W-Icon"}
    print(f"\nRICA, P={args.P} concurrent processes, nu={args.nu}, "
          f"on {args.device}")
    print(f"{'scheme':9s} {'objective':>10s} {'dist(opt)':>10s} {'speedup':>8s}")
    for mode, c in res.items():
        print(f"{label[mode]:9s} {c.objective[-1]:10.3f} "
              f"{c.dist_to_opt[-1]:10.3f} {c.speedup:8.2f}x")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for mode, c in res.items():
        axes[0].plot(c.iters, c.objective, label=label[mode])
        axes[1].plot(c.times, c.objective, label=label[mode])
        axes[2].plot(c.iters, c.dist_to_opt, label=label[mode])
    axes[0].set(xlabel="commits", ylabel="RICA objective",
                title=f"(a) objective / iteration, P={args.P}")
    axes[1].set(xlabel="simulated wall clock", title="(b) objective / time")
    axes[2].set(xlabel="commits", ylabel="||W - W*||_F",
                title="(c) distance to SGLD optimum")
    for ax in axes:
        ax.legend()
    out = os.path.join(os.path.dirname(__file__),
                       f"torch_rica_P{args.P}_nu{args.nu}.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out)


if __name__ == "__main__":
    main()
