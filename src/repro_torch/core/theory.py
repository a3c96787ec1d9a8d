"""Corollary 2.1 — theory-prescribed step sizes and iteration counts (a
copy of ``repro.core.theory``, which is pure Python).

These are the paper's explicit constants: running SGLD at (gamma_eps, n_eps)
should land inside the epsilon ball, and the tau-dependence of n_eps
follows the predicted polynomial growth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ProblemConstants:
    m: float      # strong convexity
    L: float      # gradient Lipschitz
    d: int        # dimension
    G: float      # E||grad U|| bound (Assumption 2.2)
    sigma: float  # temperature
    tau: int      # max delay
    w2sq_0: float = 1.0  # W2^2(mu_0, pi) initial distance estimate


def gamma_terms(c: ProblemConstants, eps: float) -> dict[str, float]:
    """The six step-size ceilings of Corollary 2.1."""
    m, L, d, G, sigma, tau = c.m, c.L, c.d, c.G, c.sigma, c.tau
    g1 = eps / (L * d + L**2 * tau**2 * sigma)
    g2 = math.sqrt(eps) / ((L + L**2 + tau**2 * L**2) * G**2)
    g3 = math.sqrt(eps) * m / (L * max(tau, 1) * G)
    g4 = eps ** (2.0 / 3.0) / (
        2 * sigma / (1.65 * L + math.sqrt(sigma) * math.sqrt(m))
        + 1.65 * (L / m)
        + tau * L * math.sqrt(sigma) / m
    )
    g5 = L**2 / (L**2 + L**4)
    g6 = 1.0 / 12.0
    return {"g1": g1, "g2": g2, "g3": g3, "g4": g4, "g5": g5, "g6": g6}


def gamma_eps_kl(c: ProblemConstants, eps: float) -> float:
    """Step size guaranteeing KL(nu_n | pi) <= eps."""
    return min(gamma_terms(c, eps).values()) / 4.0


def n_eps_kl(c: ProblemConstants, eps: float) -> int:
    g = gamma_eps_kl(c, eps)
    return 2 * max(math.ceil(c.w2sq_0 / (g * eps)), c.tau)


def gamma_eps_w2(c: ProblemConstants, eps: float) -> float:
    """Step size guaranteeing W2^2(mu_0 R^n, pi) <= eps."""
    return c.m * min(gamma_terms(c, eps).values()) / 8.0


def n_eps_w2(c: ProblemConstants, eps: float) -> int:
    g = gamma_eps_w2(c, eps)
    n = 2 * max(
        math.ceil(math.log(4.0 * c.w2sq_0 / eps) / (g * c.m)),
        math.ceil(math.log(max(c.tau, 2))),
    )
    return n


def inconsistent_read_bias(c: ProblemConstants, gamma: float) -> float:
    """Gradient inaccuracy bias used in the Cor. 2.1 proof (via [3] Thm 4):

    ||grad U(X_k) - grad U(X_hat_k)|| <= L tau (gamma G + sqrt(gamma sigma)).
    """
    return c.L * c.tau * (gamma * c.G + math.sqrt(gamma * c.sigma))
