"""The port's kernel wrappers on the CPU (their plain versions) held
against the reference's Pallas kernels in interpret mode, as
``tests/test_serve_kernels.py`` and ``tests/test_kernels.py`` run them:
fp32, atol = rtol = 2e-4, aligned and ragged shapes.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against these same plain versions there); here a wrapper
takes its plain version because its tensor lies on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import serve_matmul as jserve
from repro.nn.layers import quantize_int8 as jquantize

from repro_torch.kernels import ops
from repro_torch.nn.layers import quantize_int8

TOL = dict(atol=2e-4, rtol=2e-4)
SHAPES = [
    (3, 100, 72, 5),       # ragged everywhere
    (8, 64, 64, 4),
    (1, 384, 128, 32),     # one decode row
    (33, 128, 300, 7),
]


def _mats(seed, B, m, n, r, U=0):
    rng = np.random.default_rng(seed)
    lead = (U,) if U else ()
    x = rng.standard_normal((*lead, B, m)).astype(np.float32)
    fac = [(0.2 * rng.standard_normal(s)).astype(np.float32)
           for s in ((m, r), (n, r), (m, r), (n, r))]
    return x, fac


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache(w, quant):
    node = jquantize(jnp.asarray(w))
    if quant:
        return np.asarray(node["w_q"]), np.asarray(node["scale"])
    return np.asarray(w, np.float16), None


@pytest.mark.parametrize("B,m,n,r", SHAPES)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp16"])
def test_w8_matmul_matches_reference_kernel(B, m, n, r, quant):
    x, (x1, y1, x2, y2) = _mats(B + m, B, m, n, r)
    w = np.asarray(jops.fedpara_compose_ref(x1, y1, x2, y2,
                                            out_dtype=jnp.float32))
    wq, scale = _cache(w, quant)
    want = jops.w8_matmul(x, wq, scale, interpret=True, out_dtype=jnp.float32)
    got = ops.w8_matmul(_t(x), _t(wq), None if scale is None else _t(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,m,n,r", SHAPES)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp16"])
def test_cache_residual_single_user_matches_reference_kernel(B, m, n, r,
                                                             quant):
    x, (x1, y1, x2, y2) = _mats(7 * B + m, B, m, n, r)
    wq, scale = _cache(x1 @ y1.T, quant)
    want = jops.cache_residual_matmul(x, wq, scale, x2, y2, interpret=True,
                                      out_dtype=jnp.float32)
    got = ops.cache_residual_matmul(_t(x), _t(wq),
                                    None if scale is None else _t(scale),
                                    _t(x2), _t(y2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("U,t", [(1, 1), (1, 4), (3, 2), (3, 5)])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp16"])
def test_cache_residual_many_users_matches_reference_kernel(U, t, quant):
    m, n, r = 100, 72, 5
    x, (x1, y1, _, _) = _mats(U * 10 + t, t, m, n, r, U=U)
    rng = np.random.default_rng(U + t)
    ux2 = (0.2 * rng.standard_normal((U, m, r))).astype(np.float32)
    uy2 = (0.2 * rng.standard_normal((U, n, r))).astype(np.float32)
    wq, scale = _cache(x1 @ y1.T, quant)
    want = jops.cache_residual_matmul(x, wq, scale, ux2, uy2, interpret=True,
                                      out_dtype=jnp.float32)
    got = ops.cache_residual_matmul(_t(x), _t(wq),
                                    None if scale is None else _t(scale),
                                    _t(ux2), _t(uy2))
    assert got.shape == (U, t, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,m,n,r", SHAPES)
@pytest.mark.parametrize("kind", ["fedpara", "fedpara_tanh", "pfedpara"])
def test_fedpara_matmul_matches_reference_kernel(B, m, n, r, kind):
    x, fac = _mats(B * 3 + n, B, m, n, r)
    want = jops.fedpara_matmul(x, *fac, kind=kind, interpret=True,
                               out_dtype=jnp.float32)
    got = ops.fedpara_matmul(_t(x), *map(_t, fac), kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["fedpara", "pfedpara"])
@pytest.mark.parametrize("users", [0, 3])
def test_gram_decode_matches_reference(kind, users):
    m, n, r = 100, 72, 5
    x, (x1, y1, x2, y2) = _mats(11, 2, m, n, r, U=users)
    if users:
        rng = np.random.default_rng(2)
        x2 = (0.2 * rng.standard_normal((users, m, r))).astype(np.float32)
        y2 = (0.2 * rng.standard_normal((users, n, r))).astype(np.float32)
    want = jserve.fedpara_gram_decode(x, x1, y1, x2, y2, kind=kind)
    got = ops.fedpara_gram_decode(*map(_t, (x, x1, y1, x2, y2)), kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gram_decode_rejects_tanh():
    a = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        ops.fedpara_gram_decode(a, a.T, a.T, a.T, a.T, kind="fedpara_tanh")


@pytest.mark.parametrize("shape", [(100, 72), (3, 64, 96)])
def test_quantize_int8_matches_reference(shape):
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = jax.tree.map(np.asarray, jquantize(jnp.asarray(w)))
    got = quantize_int8(_t(w))
    assert got["w_q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-7,
                               atol=0)
    # codes equal except where w/scale sits on an exact .5 tie
    diff = got["w_q"].numpy().astype(np.int32) != want["w_q"].astype(np.int32)
    ratio = w / want["scale"]
    assert np.all(np.abs(np.abs(ratio[diff] % 1.0) - 0.5) < 1e-4)


def test_launch_counts_stay_zero_on_the_cpu_path():
    ops.reset_launches()
    x = torch.zeros(2, 8)
    ops.w8_matmul(x, torch.zeros(8, 4, dtype=torch.int8), torch.ones(1, 4))
    ops.fedpara_matmul(x, *(torch.zeros(d, 2) for d in (8, 4, 8, 4)))
    assert ops.launches() == {k: 0 for k in ops.KERNELS}


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.w8_matmul(x, torch.zeros(8, 4, dtype=torch.int8, device="meta"))


# ------------------------------------- the fused matmul's precision

def test_tf32_round_is_nearest_ties_away():
    """``ref.tf32_round`` keeps 10 mantissa bits, to nearest with ties
    away from zero, on the bit pattern (``csrc/mma.cuh:tf32_rna``)."""
    from repro_torch.kernels import ref

    bits = torch.tensor([0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F801001,
                         0x3F803000, 0xBF801000 - (1 << 32), 0x3F7FF000,
                         0x00000000], dtype=torch.int64).to(torch.int32)
    want = torch.tensor([0x3F800000, 0x3F800000, 0x3F802000, 0x3F802000,
                         0x3F804000, 0xBF802000 - (1 << 32), 0x3F800000,
                         0x00000000], dtype=torch.int64).to(torch.int32)
    got = ref.tf32_round(bits.view(torch.float32)).view(torch.int32)
    assert torch.equal(got, want)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = ref.split_3xtf32(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float((hi - v).abs().max() / v.abs().max()) <= 2.0 ** -11
    assert float((hi + lo - v).abs().max() / v.abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("r", [160, 70, 211])
@pytest.mark.parametrize("kind", ["fedpara", "fedpara_tanh", "pfedpara"])
def test_3xtf32_compose_keeps_fp32_accuracy(r, kind):
    """The fused matmul composes W from TF32 halves (3xTF32). At
    qwen3-8b's ranks that stays within 2e-6 of an fp64 compose, the
    accuracy the fp32 gate (1e-5) needs; a single TF32 pass does not."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(r)
    m, n = 64, 48
    fac = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(r))
                            .astype(np.float32))
           for s in ((m, r), (n, r), (m, r), (n, r))]
    want = ref._hadamard(fac[0].double() @ fac[1].double().T,
                         fac[2].double() @ fac[3].double().T, kind)
    scale = float(want.abs().max())
    three = ref.fedpara_compose_tf32(*fac, kind=kind, passes=3)
    one = ref.fedpara_compose_tf32(*fac, kind=kind, passes=1)
    err3 = float((three.double() - want).abs().max()) / scale
    err1 = float((one.double() - want).abs().max()) / scale
    assert err3 < 2e-6, err3
    assert err1 > 1e-4, err1


def test_bounds_price_fp32_products_at_the_3xtf32_rate():
    """chip_smoke.py's bounds: fp32 matrix products (composes, the Gram
    route, fp32 contractions) at 495/3 TFLOP/s, bf16 at 989; per
    qwen3-8b layer of 7 projections K1 at 512 rows takes 1.117 ms, K2
    at 4 clients x 128 rows 3.867 ms and K5 0.917 ms, within 1%."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    def layer(fn):
        return sum(fn(m, n, r) for m, n, r in cs.SHAPES.values())

    def k1(m, n, r, rows=512, clients=1):
        fo = cs.fedpara_ops(rows, m, n, r, "fedpara")
        return cs.bound_ms(0.0, clients * fo["f16"], clients * fo["f32"])[0]

    assert layer(k1) == pytest.approx(1.117, rel=0.01)
    assert layer(lambda m, n, r: k1(m, n, r, rows=128, clients=4)) == \
        pytest.approx(3.867, rel=0.01)
    assert layer(lambda m, n, r: cs.bound_ms(
        0.0, f32=cs.compose_ops(m, n, r))[0]) == pytest.approx(0.917, rel=0.01)
    # elementwise fp32 work (K7's weighted sum) keeps the CUDA-core rate
    assert cs.bound_ms(0.0, elem=67e9)[0] == pytest.approx(1.0)


# ------------------------------------- the serve kernels' precision

def test_tf32_round_is_exact_on_the_cache_types():
    """Every int8 value and every finite fp16 value is a TF32 value, so
    K8's fp32 path takes the widened cache as it is (two TF32 passes on
    x, none on W)."""
    from repro_torch.kernels import ref

    i8 = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8).float()
    assert torch.equal(ref.tf32_round(i8), i8)
    bits = torch.arange(0, 1 << 16, dtype=torch.int32)
    finite = (bits & 0x7C00) != 0x7C00
    f16 = bits[finite].to(torch.int16).view(torch.float16).float()
    assert f16.numel() == 63488
    assert torch.equal(ref.tf32_round(f16), f16)


@pytest.mark.parametrize("cache", ["int8", "fp16"])
def test_w8_two_tf32_passes_keep_fp32_accuracy(cache):
    """K8's fp32 path (``ref.w8_matmul_tf32``): at m = 4096 the two
    passes x_hi·W + x_lo·W stay within 5e-6 of an fp64 product, relative
    to the output's largest value; x_hi·W alone is at least 10x off."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(7 if cache == "int8" else 8)
    m, n = 4096, 64
    x = torch.from_numpy(rng.standard_normal((8, m)).astype(np.float32))
    if cache == "int8":
        w = torch.from_numpy(rng.integers(-127, 128, (m, n)).astype(np.int8))
        s = torch.from_numpy((1e-3 + 1e-2 * rng.random(n)).astype(np.float32))
        want = (x.double() @ w.double()) * s.double()
    else:
        w = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float16))
        s = None
        want = x.double() @ w.double()
    scale = float(want.abs().max())
    err2 = float((ref.w8_matmul_tf32(x, w, s, passes=2).double() - want)
                 .abs().max()) / scale
    err1 = float((ref.w8_matmul_tf32(x, w, s, passes=1).double() - want)
                 .abs().max()) / scale
    assert err2 < 5e-6, err2
    assert err1 >= 10 * err2, (err1, err2)


@pytest.mark.parametrize("r", [160, 70, 211])
def test_cache_residual_tf32_keeps_fp32_accuracy(r):
    """K9/K10's arithmetic (``ref.cache_residual_tf32``: the residual in
    3xTF32, the cache exact, +1, W' split into TF32 halves for a 3xTF32
    contraction with fp32 x) stays within 2e-6 of fp64 at qwen3-8b's
    ranks."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(r)
    U, t, m, n = 2, 5, 256, 64
    x = torch.from_numpy(rng.standard_normal((U, t, m)).astype(np.float32))
    w1 = (rng.standard_normal((m, r)) @ rng.standard_normal((n, r)).T) / r
    w = torch.from_numpy(w1.astype(np.float16))
    x2, y2 = (torch.from_numpy((rng.standard_normal((U, d, r)) / np.sqrt(r))
                               .astype(np.float32)) for d in (m, n))
    want = torch.einsum("utm,umn->utn", x.double(), w.double()[None]
                        * (x2.double() @ y2.double().mT + 1.0))
    got = ref.cache_residual_tf32(x, w, None, x2, y2)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 2e-6, err


@pytest.mark.parametrize("U,t,m,n,r", [(3, 5, 100, 72, 5), (2, 1, 130, 97, 37),
                                       (1, 17, 64, 300, 211)])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp16"])
def test_cache_residual_strided_users_match_reference_kernel(U, t, m, n, r,
                                                             quant):
    """Ragged users, rows, m, n and r, each user's factor slab taken from
    a strided view (user stride > m·r, as the serve arena's layer-stacked
    slabs are): the CPU path and the kernel's host twin
    (``ref.cache_residual_tf32``) against the reference kernel in
    interpret mode, at the file's tolerance."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(U * 100 + t + r)
    x = rng.standard_normal((U, t, m)).astype(np.float32)
    w1 = (0.2 * rng.standard_normal((m, r))) @ (0.2 * rng.standard_normal((n, r))).T
    wq, scale = _cache(w1.astype(np.float32), quant)
    big_x2 = (0.2 * rng.standard_normal((U, 2, m, r))).astype(np.float32)
    big_y2 = (0.2 * rng.standard_normal((U, 3, n, r))).astype(np.float32)
    ux2, uy2 = _t(big_x2)[:, 1], _t(big_y2)[:, 2]
    assert ux2.stride(0) > m * r and uy2.stride(0) > n * r
    want = np.asarray(jops.cache_residual_matmul(
        x, wq, scale, big_x2[:, 1], big_y2[:, 2], interpret=True,
        out_dtype=jnp.float32))
    s = None if scale is None else _t(scale)
    got = ops.cache_residual_matmul(_t(x), _t(wq), s, ux2, uy2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    twin = ref.cache_residual_tf32(_t(x), _t(wq), s, ux2, uy2)
    np.testing.assert_allclose(twin.numpy(), want, **TOL)
