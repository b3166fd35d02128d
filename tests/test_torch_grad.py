"""The port's differentiable fused matmul (``FedParaMatmul``: K1 forward,
K3/K4 backward) on the CPU, where it takes its plain versions, held
against the reference: ``jax.grad`` through
``repro.kernels.ops.fedpara_matmul`` (its custom VJP of Pallas kernels,
run in interpret mode as ``tests/test_kernel_grads.py`` runs them) and
the closed-form oracle ``repro.kernels.ref.fedpara_matmul_vjp_ref``.
Tolerance atol = rtol = 5e-4, the reference's own
(``tests/test_kernel_grads.py:61``). The CUDA kernels run only on the
card, where ``chip_smoke.py`` holds them against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref

KINDS = ["fedpara", "fedpara_tanh", "pfedpara"]
SHAPES = [
    (3, 100, 72, 5),       # ragged everywhere
    (64, 784, 256, 40),    # the FL MLP's fc1 at batch 64
    (64, 256, 10, 4),      # its fc2
]
TOL = dict(atol=5e-4, rtol=5e-4)
NAMES = ("dx", "dx1", "dy1", "dx2", "dy2")


def _mats(seed, B, m, n, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, m)).astype(np.float32)
    fac = [(0.2 * rng.standard_normal(s)).astype(np.float32)
           for s in ((m, r), (n, r), (m, r), (n, r))]
    return x, fac


def _jax_grads(kind, args):
    def loss(*a):
        y = jops.fedpara_matmul(*a, kind=kind, interpret=True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))


def _torch_grads(kind, args):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    y = ops.fedpara_matmul(*ts, kind=kind)
    return torch.autograd.grad(torch.sin(y.float()).sum(), ts)


@pytest.mark.parametrize("B,m,n,r", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_function_grads_match_reference_custom_vjp(B, m, n, r, kind):
    x, fac = _mats(B + m + n + r, B, m, n, r)
    want = _jax_grads(kind, (x, *fac))
    got = _torch_grads(kind, (x, *fac))
    for g, w, nm in zip(got, want, NAMES):
        assert g.dtype == torch.float32 and g.shape == w.shape, nm
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"{kind} {(B, m, n, r)} {nm}")


@pytest.mark.parametrize("B,m,n,r", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_direct_vjp_matches_reference_oracle(B, m, n, r, kind):
    x, fac = _mats(7 * B + m, B, m, n, r)
    dy = np.random.default_rng(B).standard_normal((B, n)).astype(np.float32)
    want = jref.fedpara_matmul_vjp_ref(*map(jnp.asarray, (x, *fac, dy)),
                                       kind=kind)
    tx, tf, tdy = torch.from_numpy(x), [torch.from_numpy(f) for f in fac], \
        torch.from_numpy(dy)
    oracle = ref.fedpara_matmul_vjp_ref(tx, *tf, tdy, kind=kind)
    # the wrappers the Function's backward calls (K3, K4 on the card)
    dx = ops.fedpara_dx(tdy, *tf, kind=kind, out_dtype=tx.dtype)
    dx1, dx2 = ops.fedpara_dfactors(tx, tdy, *tf, side="x", kind=kind)
    dy1, dy2 = ops.fedpara_dfactors(tx, tdy, *tf, side="y", kind=kind)
    for got in (oracle, (dx, dx1, dy1, dx2, dy2)):
        for g, w, nm in zip(got, want, NAMES):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f"{kind} {nm}")


@pytest.mark.parametrize("kind", KINDS)
def test_forward_saves_no_dense_weight(kind):
    B, m, n, r = 8, 96, 80, 6
    x, fac = _mats(5, B, m, n, r)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *fac)]
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ops.fedpara_matmul(*ts, kind=kind)
    assert sorted(sizes) == sorted(a.size for a in (x, *fac))
    assert m * n not in sizes
    y.sum().backward()
    assert all(t.grad is not None for t in ts)


def test_grads_keep_primal_dtypes_and_skip_unneeded_inputs():
    x, fac = _mats(3, 4, 40, 24, 3)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tf = [torch.from_numpy(f).requires_grad_() for f in fac]
    y = ops.fedpara_matmul(tx, *tf)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y.float().sum(), tf)
    assert all(g.dtype == torch.float32 for g in grads)
    ops.reset_launches()
    ops.fedpara_matmul(torch.from_numpy(x).requires_grad_(),
                       *map(torch.from_numpy, fac)).sum().backward()
    assert ops.launches() == {k: 0 for k in ops.KERNELS}   # host: plain
