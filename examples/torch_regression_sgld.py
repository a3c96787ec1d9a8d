"""Paper §3.2 reproduction on the PyTorch port: polynomial regression,
Sync vs W-Con vs W-Icon.

    PYTHONPATH=src python examples/torch_regression_sgld.py [--P 18] [--nu 0.1] [--device cuda]

``--device cuda`` (the default) runs the chains on a GPU; ``--device cpu``
runs the plain PyTorch path.
Reproduces Figure 1/2/3-style panels: (a) W2 to the posterior vs commits,
(b) W2 vs simulated wall clock + relative speedup, (c) the trajectory of the
first two coordinates.  Saves PNGs next to this script if matplotlib is
available, and always prints the summary table.
"""

import argparse
import os


from repro_torch.experiments import run_regression_experiment


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--P", type=int, default=18)
    ap.add_argument("--nu", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    res = run_regression_experiment(P=args.P, nu=args.nu, steps=args.steps,
                                    device=args.device)
    print(f"\npolynomial regression, P={args.P} workers, nu={args.nu}, "
          f"on {args.device}")
    print(f"{'scheme':14s} {'final W2':>10s} {'speedup':>8s}")
    label = {"sync": "Sync", "consistent": "W-Con", "inconsistent": "W-Icon"}
    for mode, c in res.items():
        print(f"{label[mode]:14s} {c.w2[-1]:10.4f} {c.speedup:8.2f}x")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available — skipping plots")
        return

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for mode, c in res.items():
        axes[0].semilogy(c.iters, c.w2, label=label[mode])
        axes[1].semilogy(c.times, c.w2, label=label[mode])
        axes[2].plot(c.traj2d[::10, 0], c.traj2d[::10, 1], ".",
                     ms=2, alpha=0.5, label=label[mode])
    axes[0].set(xlabel="commits", ylabel="W2(x_t, posterior)",
                title=f"(a) convergence / iteration, P={args.P}")
    axes[1].set(xlabel="simulated wall clock",
                title="(b) convergence / time")
    axes[2].set(xlabel="x[0]", ylabel="x[1]", title="(c) trajectory")
    for ax in axes:
        ax.legend()
    out = os.path.join(os.path.dirname(__file__),
                       f"torch_regression_P{args.P}_nu{args.nu}.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out)


if __name__ == "__main__":
    main()
