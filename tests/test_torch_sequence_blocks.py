"""repro_torch.models.ssm and .xlstm against repro.models.ssm and .xlstm:
the port's twin of ``tests/test_sequence_blocks.py``.

Float32 at the reduced hymba-1.5b (d_model 256, 4 heads, state 16) and
xlstm-1.3b (d_model 256, 2 heads).  Each block's parameters come from the
JAX init of two keys, stacked on the port's chain axis (C = 2), so chain c
is held against the reference on key c; inputs come from a numpy seed.
Full sequences, single-step decode and the decode states agree within
1e-4: the same float32 ops in the same order, only the contractions'
summation order differs (XLA's CPU dot against ATen's).  The port's own
chunk invariance and decode == parallel are held to the reference tests'
tolerances (atol 1e-4, rtol 1e-3).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs import get_reduced as jax_reduced
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_arch, get_reduced
from repro_torch.models import ssm, xlstm
from torch_cases import one_cpu_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
OWN = dict(rtol=1e-3, atol=1e-4)  # the reference tests' own tolerance
C, B = 2, 2
ARCH = {"ssm": "hymba-1.5b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}
REF = {"ssm": (jssm.init_ssm, jssm.apply_ssm),
       "mlstm": (jxlstm.init_mlstm, jxlstm.apply_mlstm),
       "slstm": (jxlstm.init_slstm, jxlstm.apply_slstm)}
PORT = {"ssm": ssm.apply_ssm, "mlstm": xlstm.apply_mlstm, "slstm": xlstm.apply_slstm}


def _cfgs(kind):
    return (replace(jax_reduced(ARCH[kind]), dtype="float32"),
            replace(get_reduced(ARCH[kind]), dtype="float32"))


def _bank(jparams):
    """A list of one-chain JAX parameter dicts as the port's (C, ...) bank."""
    return {k: torch.from_numpy(np.stack([np.asarray(p[k]) for p in jparams]))
            for k in jparams[0]}


def _setup(kind, seed):
    jcfg, tcfg = _cfgs(kind)
    init = REF[kind][0]
    jps = [init(jax.random.PRNGKey(seed + c), jcfg, jnp.float32) for c in range(C)]
    return jcfg, tcfg, jps, _bank(jps)


def _x(seed, S, d, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal((C, B, S, d))
            ).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


def _ref_state(kind, jcfg):
    if kind == "ssm":
        return jssm.init_ssm_state(jcfg, B)
    if kind == "mlstm":
        return jxlstm.init_mlstm_state(jcfg, B)
    return jxlstm.init_slstm_state(jcfg, B)


def _port_state(kind, tcfg):
    if kind == "ssm":
        return ssm.init_ssm_state(tcfg, B, torch.float32, (C,))
    if kind == "mlstm":
        return xlstm.init_mlstm_state(tcfg, B, (C,))
    return xlstm.init_slstm_state(tcfg, B, (C,))


@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
def test_full_sequence_matches_the_reference(kind):
    """128 positions: two chunks of 64 for the SSD scan and the mLSTM (the
    carry between chunks), 128 steps of the sLSTM loop."""
    jcfg, tcfg, jps, tp = _setup(kind, 1)
    S = 128 if kind != "slstm" else 48
    x = _x(2, S, jcfg.d_model)
    got = PORT[kind](tp, torch.from_numpy(x), tcfg)
    assert got.shape == (C, B, S, jcfg.d_model)
    for c in range(C):
        want = REF[kind][1](jps[c], jnp.asarray(x[c]), jcfg)
        np.testing.assert_allclose(_np(got[c]), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
def test_decode_steps_match_the_reference(kind):
    """Eight single-token steps from the initial state: outputs and every
    state leaf against the reference's."""
    jcfg, tcfg, jps, tp = _setup(kind, 3)
    x = _x(4, 8, jcfg.d_model)
    jst = [_ref_state(kind, jcfg) for _ in range(C)]
    tst = _port_state(kind, tcfg)
    for t in range(8):
        out, tst = PORT[kind](tp, torch.from_numpy(x[:, :, t:t + 1]), tcfg, state=tst)
        for c in range(C):
            want, jst[c] = REF[kind][1](jps[c], jnp.asarray(x[c, :, t:t + 1]), jcfg,
                                        state=jst[c])
            np.testing.assert_allclose(_np(out[c]), np.asarray(want), **TOL)
    for name, leaf in zip(tst._fields, tst):
        for c in range(C):
            np.testing.assert_allclose(_np(leaf[c]), np.asarray(getattr(jst[c], name)),
                                       **TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["ssm", "mlstm"])
def test_chunk_invariance(kind):
    jcfg, tcfg, jps, tp = _setup(kind, 5)
    x = torch.from_numpy(_x(6, 64, jcfg.d_model))
    outs = [_np(PORT[kind](tp, x, tcfg, chunk=c)) for c in (8, 16, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, **OWN)


@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
def test_decode_equals_parallel(kind):
    jcfg, tcfg, jps, tp = _setup(kind, 7)
    S = 32
    x = torch.from_numpy(_x(8, S, jcfg.d_model))
    par = PORT[kind](tp, x, tcfg)
    st, ys = _port_state(kind, tcfg), []
    for t in range(S):
        y, st = PORT[kind](tp, x[:, :, t:t + 1], tcfg, state=st)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, dim=2)), _np(par), **OWN)


@pytest.mark.parametrize("kind", ["ssm", "mlstm"])
def test_a_sequence_the_chunk_does_not_divide_is_refused(kind):
    """100 positions in chunks of 64: both packages refuse (no padding)."""
    jcfg, tcfg, jps, tp = _setup(kind, 9)
    x = _x(10, 100, jcfg.d_model)
    with pytest.raises(AssertionError):
        REF[kind][1](jps[0], jnp.asarray(x[0]), jcfg)
    with pytest.raises(AssertionError, match="not divisible"):
        PORT[kind](tp, torch.from_numpy(x), tcfg)


def test_ssd_state_decays():
    """With zero input the SSD state decays (A < 0): an impulse's
    contribution vanishes over time."""
    jcfg, tcfg, jps, tp = _setup("ssm", 11)
    st = _port_state("ssm", tcfg)
    _, st = ssm.apply_ssm(tp, torch.ones(C, B, 1, tcfg.d_model), tcfg, state=st)
    h0 = float(st.h.abs().max())
    for _ in range(200):
        _, st = ssm.apply_ssm(tp, torch.zeros(C, B, 1, tcfg.d_model), tcfg, state=st)
    assert float(st.h.abs().max()) < h0


def test_slstm_gating_stable_at_large_preactivations():
    """Gate pre-activations of order 30: the stabiliser m keeps every value
    finite, and the port still agrees with the reference."""
    jcfg, tcfg, jps, tp = _setup("slstm", 12)
    x = _x(13, 64, jcfg.d_model, scale=30.0)
    got = xlstm.apply_slstm(tp, torch.from_numpy(x), tcfg)
    assert bool(torch.isfinite(got).all())
    want = jxlstm.apply_slstm(jps[0], jnp.asarray(x[0]), jcfg)
    assert bool(jnp.all(jnp.isfinite(want)))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_softplus_is_jax_softplus_past_its_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns x
    above 20, the port's does not."""
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.0, 20.5, 25.0, 40.0], np.float32)
    got = ssm.softplus(torch.from_numpy(x))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(_np(got), want)


_DETERMINISTIC = {
    "ssm": ("a_log", "d_skip", "norm", "conv_b"),
    "mlstm": ("gates_b", "norm", "skip"),
    "slstm": ("bias", "norm"),
}


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
def test_deterministic_init_leaves_equal_the_references(kind, width):
    """The leaves the init does not draw are the reference's bit for bit
    (``a_log = log(1..H)`` through XLA's float32 log, ones, zeros, the
    mLSTM's per-head forget biases), at the reduced and the published
    widths — but the sLSTM's ``linspace(3, 6, d_model)`` forget biases:
    XLA's CPU code for ``jnp.linspace`` fuses its multiply-adds differently
    with the length, so those are within one ulp of the reference's (a
    difference by design; every other entry of the bias is equal)."""
    get_j, get_t = (jax_reduced, get_reduced) if width == "reduced" else (jax_arch, get_arch)
    jcfg, tcfg = get_j(ARCH[kind]), get_t(ARCH[kind])
    if width == "full":  # the deterministic leaves do not depend on the depth
        jcfg, tcfg = replace(jcfg, num_layers=1), replace(tcfg, num_layers=1)
    jp = REF[kind][0](jax.random.PRNGKey(0), jcfg, jnp.float32)
    init = {"ssm": ssm.init_ssm, "mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}
    tp = init[kind](torch.Generator().manual_seed(0), tcfg, torch.float32, (2,))
    for name in _DETERMINISTIC[kind]:
        want = np.asarray(jp[name])
        for c in range(2):
            got = _np(tp[name][c])
            assert got.dtype == want.dtype, name
            if kind == "slstm" and name == "bias":
                d = tcfg.d_model
                np.testing.assert_array_equal(np.delete(got, np.s_[d:2 * d]),
                                              np.delete(want, np.s_[d:2 * d]))
                ulps = np.abs(got[d:2 * d].view(np.int32).astype(np.int64)
                              - want[d:2 * d].view(np.int32).astype(np.int64))
                assert ulps.max() <= 1, name
                assert got[d] == want[d] == 3.0 and got[2 * d - 1] == want[2 * d - 1] == 6.0
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    drawn = [k for k in jp if k not in _DETERMINISTIC[kind]]
    for name in drawn:  # the drawn leaves: the reference's shapes and dtypes
        assert tuple(tp[name].shape[1:]) == jp[name].shape, name
        assert str(tp[name].dtype).replace("torch.", "") == str(jp[name].dtype), name


def test_ssd_gradient_stays_finite_where_the_references_overflows():
    """A difference by design.  The reference masks the intra-chunk decay
    after its exp (``where(tri, exp(logw), 0)``): where a masked pair's
    ``seg_t - seg_s`` overflows the exp (a large dt), its forward is finite
    but its gradient is ``0 * inf = NaN``.  The port masks before the exp:
    the same forward, a finite gradient, and the reference's gradient
    wherever that one is finite (``tests/test_torch_archs.py``)."""
    jcfg, tcfg, jps, tp = _setup("ssm", 14)
    jp = [dict(p, dt_bias=p["dt_bias"] + 12.0) for p in jps]  # dt ~ 10 a step
    tp = dict(tp, dt_bias=tp["dt_bias"] + 12.0)
    x = _x(15, 64, jcfg.d_model)
    jloss = lambda p: jnp.sum(jssm.apply_ssm(p, jnp.asarray(x[0]), jcfg) ** 2)  # noqa: E731
    jgrad = jax.grad(jloss)(jp[0])
    assert not bool(jnp.isfinite(jgrad["dt_bias"]).all())
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out = ssm.apply_ssm(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(out[0]), np.asarray(jssm.apply_ssm(
        jp[0], jnp.asarray(x[0]), jcfg)), **TOL)
    out[0].square().sum().backward()
    for name, t in tp.items():
        assert bool(torch.isfinite(t.grad).all()), name
