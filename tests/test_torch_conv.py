"""The port's low-rank kind, Prop.-3 tensor FedPara for convolutions, the
conv half of the rank policy and the Jacobian correction, held against
the reference on the CPU.

* Inits by statistics (``jax.random`` and torch draw different numbers):
  shapes and parameter counts exact, factor stds within 5% of the law,
  the composed weight's variance near He's.
* Composes, ``materialize``, ``materialize_conv``, ``materialize_auto``
  and the penalty within 1e-5 of the reference on converted factors.
* The rank policy by exact integers over the shapes of
  ``tests/test_rank_policy_edge.py`` and ``tests/test_rank_properties.py``
  (Prop. 3's unfolding rank <= R², Table 1's counts).
* ``--param lowrank`` trains the MLP through the port's layers as the
  reference's do (a dense of kind lowrank materializes and multiplies).
"""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import ParamCfg as JParamCfg
from repro.core import parameterization as jpar
from repro.core import rank_policy as jrp
from repro.core import regularization as jreg
from repro.core import tensor_fedpara as jtf
from repro.nn import layers as jlayers
from repro.nn import recurrent as jrec

from repro_torch import interop
from repro_torch.configs.base import ParamCfg
from repro_torch.core import parameterization as par
from repro_torch.core import rank_policy as rp
from repro_torch.core import regularization as reg
from repro_torch.core import tensor_fedpara as tf
from repro_torch.nn import layers
from repro_torch.nn import recurrent as rec

TOL = dict(rtol=1e-5, atol=1e-5)


def _factors(seed, shapes, scale=0.3):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------ rank policy

MATRIX = sorted(set(itertools.product((2, 3, 4, 7, 8, 16, 33, 64, 96, 100,
                                       256, 512), repeat=2)))
CONV = [(o, i, k) for o in (2, 4, 7, 32, 64, 128, 256, 512)
        for i in (2, 3, 4, 16, 64, 128, 256, 512) for k in (1, 3, 5)]
GAMMAS = (0.0, 0.05, 0.1, 0.3, 0.5, 0.6, 0.9, 1.0)


def test_matrix_policy_equals_reference_exactly():
    for m, n in MATRIX:
        assert rp.matrix_rmin(m, n) == jrp.matrix_rmin(m, n)
        assert rp.matrix_rmax(m, n) == jrp.matrix_rmax(m, n)
        for g in GAMMAS:
            assert rp.resolve_matrix(m, n, g) == _spec(
                jrp.resolve_matrix(m, n, g))
        for r in (1, 3, 16):
            assert rp.matrix_param_count(m, n, r) == \
                jrp.matrix_param_count(m, n, r)
        for budget in (1, m + n - 1, m + n, 7 * (m + n) + 3, m * n):
            assert rp.lowrank_rank_for_params(m, n, budget) == \
                jrp.lowrank_rank_for_params(m, n, budget)


def _spec(s):
    return rp.RankSpec(r=s.r, r_min=s.r_min, r_max=s.r_max, params=s.params,
                       dense_params=s.dense_params)


def test_conv_policy_equals_reference_exactly():
    for o, i, k in CONV:
        assert rp.conv_rmin(o, i) == jrp.conv_rmin(o, i)
        assert rp.conv_rmax(o, i, k, k) == jrp.conv_rmax(o, i, k, k)
        for g in GAMMAS:
            assert rp.conv_rank_for_gamma(o, i, k, k, g) == \
                jrp.conv_rank_for_gamma(o, i, k, k, g)
            got, want = rp.resolve_conv(o, i, k, k, g), \
                jrp.resolve_conv(o, i, k, k, g)
            assert got == _spec(want)
            assert got.compression == want.compression
        for r in (1, 2, 16):
            assert rp.conv_param_count(o, i, k, k, r) == \
                jrp.conv_param_count(o, i, k, k, r)
            assert rp.conv_reshape_param_count(o, i, k, k, r) == \
                jrp.conv_reshape_param_count(o, i, k, k, r)
    # Table 1: m = n = O = I = 256, K = 3, R = 16
    assert rp.matrix_param_count(256, 256, 16) == 16384
    assert rp.conv_param_count(256, 256, 3, 3, 16) == 20992
    assert rp.conv_reshape_param_count(256, 256, 3, 3, 16) == 81920
    # parity at r_max whenever the rank-1 layer is below the dense count
    for o, i, k in CONV:
        rmax = rp.conv_rmax(o, i, k, k)
        if o >= 4 and i >= 4 and rp.conv_param_count(o, i, k, k, 1) <= \
                o * i * k * k:
            assert rp.conv_param_count(o, i, k, k, rmax) <= o * i * k * k
            assert rp.conv_param_count(o, i, k, k, rmax + 1) > o * i * k * k


@pytest.mark.parametrize("o,i,r", [(4, 4, 1), (9, 17, 2), (32, 20, 3),
                                   (32, 32, 5)])
def test_prop3_unfolding_rank_and_conv_compose(o, i, r):
    f = _factors(o * i + r, {"t1": (r, r, 3, 3), "x1": (o, r), "y1": (i, r),
                             "t2": (r, r, 3, 3), "x2": (o, r), "y2": (i, r)})
    w = tf.compose_conv_fedpara({k: torch.from_numpy(v).double()
                                 for k, v in f.items()})
    assert w.shape == (o, i, 3, 3)
    assert torch.linalg.matrix_rank(w.reshape(o, -1)) <= r * r
    assert torch.linalg.matrix_rank(w.transpose(0, 1).reshape(i, -1)) <= r * r


# ---------------------------------------------------------------- low-rank

def test_lowrank_kind_init_statistics():
    gen = torch.Generator().manual_seed(0)
    m, n, g = 512, 256, 0.3
    node = par.init_linear(gen, m, n, kind="lowrank", gamma=g)
    jnode = jpar.init_linear(jax.random.PRNGKey(0), m, n, kind="lowrank",
                             gamma=g)
    r = 2 * rp.matrix_rank_for_gamma(m, n, g)
    assert {k: tuple(v.shape) for k, v in node.items()} == \
        {k: tuple(v.shape) for k, v in jnode.items()} == \
        {"x": (m, r), "y": (n, r)}
    std = par.lowrank_factor_std(m, r)
    assert std == jpar.lowrank_factor_std(m, r)
    for k in ("x", "y"):
        assert abs(node[k].std().item() / std - 1) < 0.05
    assert par.resolve_rank(m, n, "lowrank", g, None) == \
        jpar.resolve_rank(m, n, "lowrank", g, None)
    assert par.resolve_rank(m, n, "lowrank", g, 7) == 7
    rmin = rp.matrix_rmin(512, 512)
    w = par.compose_lowrank(par.init_lowrank(gen, 512, 512, 2 * rmin))
    assert abs(float(w.var()) - 2.0 / 512) < 0.3 * (2.0 / 512)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_lowrank_compose_and_materialize_equal_reference(dtype):
    f = _factors(1, {"x": (40, 6), "y": (30, 6)})
    jdt = None if dtype is None else jnp.bfloat16
    want = np.asarray(jpar.materialize(_j(f), "lowrank", jdt), np.float32)
    got = par.materialize(interop.from_jax_params(f), "lowrank", dtype)
    assert got.dtype == (dtype or torch.float32)
    tol = TOL if dtype is None else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    stacked = _factors(2, {"x": (3, 40, 6), "y": (3, 30, 6)})
    np.testing.assert_allclose(
        par.compose_lowrank(interop.from_jax_params(stacked)).numpy(),
        np.asarray(jpar.compose_lowrank(_j(stacked))), **TOL)
    with pytest.raises(ValueError, match="unknown parameterization kind"):
        par.materialize(interop.from_jax_params(f), "bogus")


def test_materialize_auto_equals_reference_on_every_factor_set():
    r, o, i = 3, 8, 5
    nodes = {
        "lowrank": _factors(3, {"x": (16, 4), "y": (12, 4)}),
        "conv_fedpara": _factors(4, {"t1": (r, r, 3, 3), "x1": (o, r),
                                     "y1": (i, r), "t2": (r, r, 3, 3),
                                     "x2": (o, r), "y2": (i, r)}),
        "conv_lowrank": _factors(5, {"t": (r, r, 3, 3), "x": (o, r),
                                     "y": (i, r)}),
        "fedpara": _factors(6, {"x1": (16, 4), "y1": (12, 4),
                                "x2": (16, 4), "y2": (12, 4)}),
    }
    for name, node in nodes.items():
        for hint in ("fedpara", "fedpara_tanh", "lowrank", "pfedpara"):
            want = np.asarray(jlayers.materialize_auto(_j(node), hint))
            got = layers.materialize_auto(interop.from_jax_params(node), hint)
            np.testing.assert_allclose(got.numpy(), want, **TOL,
                                       err_msg=f"{name} {hint}")


# -------------------------------------------------------- Prop.-3 conv

@pytest.mark.parametrize("kind", ["fedpara", "fedpara_tanh", "lowrank",
                                  "original"])
def test_conv_init_statistics_and_layout(kind):
    o, i, k, g = 128, 128, 3, 0.0
    gen = torch.Generator().manual_seed(1)
    node = tf.init_conv(gen, o, i, k, k, kind=kind, gamma=g)
    jnode = jtf.init_conv(jax.random.PRNGKey(1), o, i, k, k, kind=kind,
                          gamma=g)
    assert {n: tuple(v.shape) for n, v in node.items()} == \
        {n: tuple(v.shape) for n, v in jnode.items()}
    assert par.num_params(node) == sum(int(np.prod(v.shape))
                                       for v in jnode.values())
    fan_in = i * k * k
    if kind in ("fedpara", "fedpara_tanh"):
        r = rp.conv_rank_for_gamma(o, i, k, k, g)
        std = (2.0 / fan_in) ** (1 / 12) / r ** (1 / 3)
        assert par.num_params(node) == rp.conv_param_count(o, i, k, k, r)
    elif kind == "lowrank":
        r = 2 * rp.conv_rank_for_gamma(o, i, k, k, g)
        std = (2.0 / fan_in) ** (1 / 3) / r ** (1 / 3)
    else:
        std = (2.0 / fan_in) ** 0.5
    for name, v in node.items():   # both sides draw from the same law
        tol = 4.0 / math.sqrt(2 * v.numel())   # 4 sigma of a sample std
        assert abs(v.std().item() / std - 1) < tol, name
        assert abs(float(np.asarray(jnode[name]).std()) / std - 1) < tol
    if kind == "fedpara":   # the composed kernel's variance near He's
        w = tf.compose_conv_fedpara(node)
        tgt = 2.0 / fan_in
        assert abs(float(w.var()) - tgt) < 0.35 * tgt
    with pytest.raises(ValueError, match="unknown conv parameterization"):
        tf.init_conv(gen, o, i, k, k, kind="pfedpara")


@pytest.mark.parametrize("kind", ["fedpara", "fedpara_tanh", "lowrank",
                                  "original"])
def test_materialize_conv_and_forward_equal_reference(kind):
    r, o, i = 4, 12, 7
    if kind == "original":
        node = _factors(7, {"w": (o, i, 3, 3)})
    elif kind == "lowrank":
        node = _factors(8, {"t": (r, r, 3, 3), "x": (o, r), "y": (i, r)})
    else:
        node = _factors(9, {"t1": (r, r, 3, 3), "x1": (o, r), "y1": (i, r),
                            "t2": (r, r, 3, 3), "x2": (o, r), "y2": (i, r)})
    want = np.asarray(jtf.materialize_conv(_j(node), kind))
    got = tf.materialize_conv(interop.from_jax_params(node), kind)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    half = tf.materialize_conv(interop.from_jax_params(node), kind,
                               torch.float16)
    assert half.dtype == torch.float16
    # the OIHW kernel feeds F.conv2d as the reference's conv (NHWC, HWIO)
    x = np.random.default_rng(0).standard_normal((2, 9, 9, i)).astype(
        np.float32)
    jy = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.transpose(jnp.asarray(want), (2, 3, 1, 0)),
        (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ty = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), got, padding=1)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="unknown conv parameterization"):
        tf.materialize_conv(interop.from_jax_params(node), "pfedpara")


def test_vgg16_widest_conv_composes_as_the_reference():
    """VGG16's widest conv (512 -> 512, 3x3) at gamma 0.1, fedpara and
    lowrank, composed from converted factors (relative 1e-5)."""
    o = i = 512
    r = rp.conv_rank_for_gamma(o, i, 3, 3, 0.1)
    for kind, shapes in (("fedpara", {"t1": (r, r, 3, 3), "x1": (o, r),
                                      "y1": (i, r), "t2": (r, r, 3, 3),
                                      "x2": (o, r), "y2": (i, r)}),
                         ("lowrank", {"t": (2 * r, 2 * r, 3, 3),
                                      "x": (o, 2 * r), "y": (i, 2 * r)})):
        node = _factors(10, shapes, scale=0.1)
        want = np.asarray(jtf.materialize_conv(_j(node), kind))
        got = tf.materialize_conv(interop.from_jax_params(node), kind).numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# --------------------------------------------------- Jacobian correction

def _reg_factors(seed):
    return _factors(seed, {"x1": (20, 3), "y1": (14, 3), "x2": (20, 3),
                           "y2": (14, 3)})


def test_jacobian_penalty_equals_reference():
    f = _reg_factors(11)
    jw = np.random.default_rng(12).standard_normal((20, 14)).astype(
        np.float32)
    for eta in (0.0, 0.05, 0.5):
        want = float(jreg.jacobian_correction_penalty(_j(f), jnp.asarray(jw),
                                                      eta))
        got = float(reg.jacobian_correction_penalty(
            interop.from_jax_params(f), torch.from_numpy(jw), eta))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert float(reg.jacobian_correction_penalty(
        interop.from_jax_params(f), torch.from_numpy(jw), 0.0)) < 1e-6


def test_jacobian_corrected_loss_and_its_gradient_equal_reference():
    """R = L(W) + λ/2·penalty and dR/d(factors), J_W detached as the
    reference's stop_gradient."""
    f = _reg_factors(13)
    target = np.random.default_rng(14).standard_normal((20, 14)).astype(
        np.float32)

    def jloss(w):
        return jnp.sum(jnp.tanh(w) * jnp.asarray(target)) + jnp.sum(w * w)

    def tloss(w):
        return torch.sum(torch.tanh(w) * torch.from_numpy(target)) + \
            torch.sum(w * w)

    lam, eta = 0.7, 0.1
    want, wgrad = jax.value_and_grad(
        lambda p: jreg.fedpara_loss_with_jacobian_correction(
            jloss, p, lam, eta))(_j(f))
    tp = {k: v.requires_grad_() for k, v in
          interop.from_jax_params(f).items()}
    got = reg.fedpara_loss_with_jacobian_correction(tloss, tp, lam, eta)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    grads = torch.autograd.grad(got, [tp[k] for k in sorted(tp)])
    for k, g in zip(sorted(tp), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wgrad[k]), **TOL,
                                   err_msg=k)
    with torch.no_grad():   # no graph to the factors: J_W of W alone
        plain = reg.fedpara_loss_with_jacobian_correction(
            tloss, interop.from_jax_params(f), lam, eta)
    assert float(plain) == pytest.approx(float(want), rel=1e-5)


# ------------------------------------------------------- the MLP, lowrank

def test_lowrank_mlp_forward_and_grads_equal_reference():
    """The MLP of kind lowrank (``--param lowrank``): its layers
    materialize W = X Yᵀ and multiply, 2-D and client-stacked, with or
    without ``use_kernels`` (no kernel exists for the kind)."""
    jcfg = jrec.MLPConfig(in_dim=64, hidden=32, classes=10,
                          param=JParamCfg(kind="lowrank", gamma=0.3,
                                          min_dim_for_factorization=8))
    params = jax.tree.map(np.asarray, jrec.init_mlp_model(
        jax.random.PRNGKey(0), jcfg))
    assert set(params["fc1"]) == {"x", "y"}
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((16, 64)).astype(np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int32)}
    want, wgrad = jax.value_and_grad(
        lambda p: jrec.mlp_loss(p, jcfg, _j(batch)))(_j(params))
    for use in (False, True):
        cfg = rec.MLPConfig(in_dim=64, hidden=32, classes=10,
                            param=ParamCfg(kind="lowrank", gamma=0.3,
                                           min_dim_for_factorization=8,
                                           use_kernels=use))
        tp = interop.from_jax_params(params)
        for v in jax.tree.leaves(tp):
            v.requires_grad_()
        loss = rec.mlp_loss(tp, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
        loss.backward()
        np.testing.assert_allclose(tp["fc1"]["x"].grad.numpy(),
                                   np.asarray(wgrad["fc1"]["x"]), **TOL)
        stacked = {k: torch.from_numpy(np.stack([v, v]))
                   for k, v in batch.items()}
        tp2 = jax.tree.map(lambda a: torch.stack([a.detach()] * 2),
                           interop.from_jax_params(params))
        per = rec.mlp_loss_clients(tp2, cfg, stacked)
        np.testing.assert_allclose(per.detach().numpy(),
                                   [float(want)] * 2, rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    init = rec.init_mlp_model(gen, cfg)
    assert {k: tuple(v.shape) for k, v in init["fc1"].items()} == \
        {k: tuple(v.shape) for k, v in params["fc1"].items()}
    assert par.num_params(init) == sum(
        int(np.prod(v.shape)) for v in jax.tree.leaves(params))
    assert math.isfinite(float(rec.mlp_loss(init, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})))
