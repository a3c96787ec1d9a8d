"""repro_torch.models.moe against repro.models.moe (its ``mesh=None``
path): the port's twin of ``tests/test_moe.py``.

Float32, the reduced phi3.5-moe (4 experts, top-2) and a reduced kimi-k2
widened to 16 experts, top-8, one shared expert.  Weights come from the
JAX init as numpy, with a leading chain axis of 1 for the port; inputs
from a numpy seed.  Outputs and gradients agree within 1e-5 / 1e-4: the
same ops in the same order, only the matmuls' summation order differs
(XLA's CPU dot against ATen's).  The routing, capacity drops and the aux
loss do not depend on that order here, so the dropped sets are equal.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models.common import activation as jax_activation
from repro_torch.configs import get_reduced
from repro_torch.models import moe
from repro_torch.models.common import activation
from repro_torch.utils import tree_map
from torch_cases import one_cpu_thread  # noqa: F401

PHI = "phi3.5-moe-42b-a6.6b"
KIMI = "kimi-k2-1t-a32b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **over):
    return (replace(jax_reduced(arch), dtype="float32", **over),
            replace(get_reduced(arch), dtype="float32", **over))


def _bank(jparams, C=1):
    """One chain's JAX parameters as a port bank of C copies."""
    return tree_map(lambda a: torch.from_numpy(np.array(a))[None].repeat(
        C, *([1] * np.ndim(a))), dict(jparams))


def _np(t):
    return t.detach().cpu().numpy()


def test_top1_routing_selects_expert():
    """With a hand-built router, tokens go to the intended expert, as in the
    reference."""
    jcfg, tcfg = _cfgs(PHI, experts_per_token=1, num_experts=4)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    d = jcfg.d_model
    p = dict(p, router=jnp.zeros((d, 4)).at[0, 0].set(10.0).at[0, 1].set(-10.0))
    xt = jnp.zeros((8, d)).at[:4, 0].set(1.0).at[4:, 0].set(-1.0)
    want, _ = jmoe._moe_local(p, xt, jcfg, 4, 0, jmoe.capacity(8, jcfg),
                              jax_activation(jcfg.act))
    got, _ = moe._moe_local(_bank(p), torch.from_numpy(np.array(xt))[None],
                            tcfg, moe.capacity(8, tcfg), activation(tcfg.act))
    o = _np(got[0])
    np.testing.assert_allclose(o, np.asarray(want), **TOL)
    np.testing.assert_allclose(o[0], o[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o[4], o[5], rtol=1e-5, atol=1e-6)
    assert np.abs(o[0] - o[4]).max() > 1e-4


def test_capacity_drop_keeps_the_references_pairs():
    """Every token routed to expert 0 at capacity 4 of 32 tokens: 28 pairs
    drop, and the kept four are the reference's (the first four tokens,
    token-major ranks), with its outputs."""
    jcfg, tcfg = _cfgs(PHI, experts_per_token=1, num_experts=4)
    p = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    d = jcfg.d_model
    p = dict(p, router=jnp.zeros((d, 4)).at[0, 0].set(10.0))
    xt = np.random.default_rng(0).standard_normal((32, d)).astype(np.float32)
    xt[:, 0] = 1.0  # every token to expert 0
    want, _ = jmoe._moe_local(p, jnp.asarray(xt), jcfg, 4, 0, 4,
                              jax_activation(jcfg.act))
    moe.reset_dropped()
    got, _ = moe._moe_local(_bank(p), torch.from_numpy(xt)[None], tcfg, 4,
                            activation(tcfg.act))
    assert moe.dropped_pairs() == 28
    kept_want = np.flatnonzero(np.abs(np.asarray(want)).max(axis=1) > 1e-7)
    kept_got = np.flatnonzero(np.abs(_np(got[0])).max(axis=1) > 1e-7)
    np.testing.assert_array_equal(kept_got, kept_want)
    np.testing.assert_array_equal(kept_got, [0, 1, 2, 3])
    np.testing.assert_allclose(_np(got[0]), np.asarray(want), **TOL)


def test_aux_loss_uniform_router_is_one():
    """A uniform router: top-1 ties go to expert 0 (the lower index, as
    ``lax.top_k``), so aux = E * (1 * 1/E) = 1, as in the reference."""
    jcfg, tcfg = _cfgs(PHI, num_experts=4, experts_per_token=1)
    p = jmoe.init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    p = dict(p, router=jnp.zeros((jcfg.d_model, 4)))
    xt = np.random.default_rng(3).standard_normal((64, jcfg.d_model)).astype(np.float32)
    _, want = jmoe._moe_local(p, jnp.asarray(xt), jcfg, 4, 0,
                              jmoe.capacity(64, jcfg), jax_activation(jcfg.act))
    _, aux = moe._moe_local(_bank(p), torch.from_numpy(xt)[None], tcfg,
                            moe.capacity(64, tcfg), activation(tcfg.act))
    assert aux.shape == (1,)
    assert float(aux[0]) == pytest.approx(1.0, rel=1e-6)
    assert float(aux[0]) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("arch,over", [(PHI, {}),
                                       (KIMI, dict(num_experts=16, experts_per_token=8))],
                         ids=["phi3.5-moe", "kimi-k8-shared"])
def test_apply_moe_matches_jax(arch, over):
    """``apply_moe`` at the reduced widths, 4 x 16 tokens: outputs, aux,
    the number of dropped pairs and every gradient (router included)."""
    jcfg, tcfg = _cfgs(arch, **over)
    p = jmoe.init_moe(jax.random.PRNGKey(4), jcfg, jnp.float32)
    x = np.random.default_rng(5).standard_normal((4, 16, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.apply_moe(p, x, jcfg, mesh=None)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(p, jnp.asarray(x))
    bank = tree_map(lambda t: t.requires_grad_(), _bank(p))
    moe.reset_dropped()
    y, aux = moe.apply_moe(bank, torch.from_numpy(x)[None], tcfg)
    (torch.sum(y ** 2) + aux.sum()).backward()
    np.testing.assert_allclose(_np(y[0]), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(aux), [float(jaux)], rtol=1e-5)
    for name, g in jg.items():
        np.testing.assert_allclose(_np(bank[name].grad[0]), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(torch.sum(bank["router"].grad ** 2)) > 0
    if jcfg.num_shared_experts:
        assert "shared_w_gate" in bank
    # the drop count is the reference's: its kept pairs rebuilt from its own
    # routing
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(xt @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.num_experts)
    cap = jmoe.capacity(xt.shape[0], jcfg)
    assert moe.dropped_pairs() == int(np.maximum(counts - cap, 0).sum())


def test_bank_of_chains_equals_each_chain_alone():
    """A bank of 3 chains (own weights, own tokens) is bit for bit each
    chain run alone: capacity and routing are per chain."""
    _, tcfg = _cfgs(KIMI, num_experts=16, experts_per_token=8)
    gen = torch.Generator().manual_seed(0)
    bank = moe.init_moe(gen, tcfg, torch.float32, lead=(3,))
    x = torch.randn(3, 2, 24, tcfg.d_model, generator=gen)
    x += 3 * torch.randn(3, 1, 1, tcfg.d_model, generator=gen)  # a chain's
    # tokens lean to the same experts: some overflow
    moe.reset_dropped()
    y, aux = moe.apply_moe(bank, x, tcfg)
    together = moe.dropped_pairs()
    assert together > 0  # 48 tokens x 8 slots over 16 experts, capacity 30
    moe.reset_dropped()
    for c in range(3):
        yc, auxc = moe.apply_moe(tree_map(lambda t, c=c: t[c:c + 1], bank),
                                 x[c:c + 1], tcfg)
        assert torch.equal(yc[0], y[c]) and torch.equal(auxc[0], aux[c])
    assert moe.dropped_pairs() == together


def test_shared_expert_contributes():
    _, tcfg = _cfgs(PHI, num_experts=4, experts_per_token=2, num_shared_experts=1)
    gen = torch.Generator().manual_seed(6)
    p = moe.init_moe(gen, tcfg, torch.float32, lead=(1,))
    x = torch.randn(1, 1, 4, tcfg.d_model, generator=gen)
    y1, _ = moe.apply_moe(p, x, tcfg)
    y2, _ = moe.apply_moe(dict(p, shared_w_down=torch.zeros_like(p["shared_w_down"])),
                          x, tcfg)
    assert float((y1 - y2).abs().max()) > 1e-5
