"""The port's compose path and the decoder's training forward held
against the reference on the CPU.

* ``ops.fedpara_compose`` with each kind (K5/K6's plain versions on a
  host tensor) against the reference's Pallas kernel in
  interpret mode at ``tests/test_kernels.py``'s shapes and
  ``tests/test_fl_batched.py``'s stacked one: atol = rtol = 1e-5, the
  reference's own bound; the host twin of the kernels' 3xTF32
  arithmetic (``ref.fedpara_compose_tf32``) likewise, and both against
  fp64 at ranks up to 1100;
* the serve caches and ``precompose_tree`` (bf16 and int8) against the
  reference's on reference-initialized params;
* ``make_token_lm_dataset`` bit for bit;
* ``DecoderLM.loss`` and its gradients against the reference's
  ``model.loss`` and ``jax.grad`` (reduced qwen3-8b, 2 layers, fp32),
  kernels off and on, within ``DEFAULT_ATOL = 1e-4``
  (``tests/parity.py:54``).

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds K5/K6 against these plain versions there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity import DEFAULT_ATOL
from repro.configs import get_arch as jax_get_arch
from repro.data import make_token_lm_dataset as jax_token_data
from repro.kernels import ops as jops
from repro.nn.layers import precompose_tree as jax_precompose_tree
from repro.nn.transformer import ModelOptions as JaxOptions
from repro.nn.transformer import build_model as jax_build_model

from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import make_token_lm_dataset
from repro_torch.kernels import fedpara_compose as fc
from repro_torch.kernels import ops, ref
from repro_torch.nn.layers import precompose_tree
from repro_torch.nn.transformer import ModelOptions, build_model
from repro_torch.tree import tree_leaves

COMPOSE_TOL = dict(atol=1e-5, rtol=1e-5)
KINDS = ["fedpara", "fedpara_tanh", "pfedpara"]


def _factors(seed, lead, m, n, r, std):
    rng = np.random.default_rng(seed)
    return [(std * rng.standard_normal((*lead, d, r))).astype(np.float32)
            for d in (m, n, m, n)]


def _jax_compose(fac, kind):
    if kind == "pfedpara":
        return jops.pfedpara_compose(*fac, interpret=True, block_m=128,
                                     block_n=128)
    return jops.fedpara_compose(*fac, use_tanh=kind == "fedpara_tanh",
                                interpret=True, block_m=128, block_n=128)


def _jax_compose_to(fac, kind, out_dtype):
    """:func:`_jax_compose` rounded once to ``out_dtype`` by the kernel."""
    if kind == "pfedpara":
        return jops.pfedpara_compose(*fac, interpret=True, block_m=128,
                                     block_n=128, out_dtype=out_dtype)
    return jops.fedpara_compose(*fac, use_tanh=kind == "fedpara_tanh",
                                interpret=True, block_m=128, block_n=128,
                                out_dtype=out_dtype)


@pytest.mark.parametrize("m,n,r", [(64, 64, 4), (100, 52, 3), (256, 256, 16),
                                   (300, 128, 9)])
@pytest.mark.parametrize("kind", KINDS)
def test_compose_matches_reference_kernel(m, n, r, kind):
    fac = _factors(m + n + r, (), m, n, r, 0.2)
    want = np.asarray(_jax_compose(fac, kind))
    got = ops.fedpara_compose(*map(torch.from_numpy, fac), kind=kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **COMPOSE_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_compose_matches_reference_kernel(kind):
    """K6's function: a leading axis of 2 at 96 x 130, r = 4."""
    fac = _factors(7, (2,), 96, 130, 4, 1.0)
    want = np.asarray(_jax_compose(fac, kind))
    got = ops.fedpara_compose(*map(torch.from_numpy, fac), kind=kind)
    assert tuple(got.shape) == (2, 96, 130)
    np.testing.assert_allclose(got.numpy(), want, **COMPOSE_TOL)


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16)])
def test_compose_rounds_once_to_the_requested_type(dtype, jdtype):
    """W is composed in fp32 and rounded once, as the reference casts
    (``fedpara_compose.py:39``): the same codes, or the neighbouring one
    where the two fp32 sums straddle a rounding boundary."""
    fac = _factors(3, (3,), 100, 52, 3, 0.5)
    want = np.asarray(jops.fedpara_compose(
        *fac, interpret=True, block_m=128, block_n=128,
        out_dtype=jdtype)).astype(np.float32)
    got = ops.fedpara_compose(*map(torch.from_numpy, fac), out_dtype=dtype)
    assert got.dtype == dtype
    ulp = 2.0 ** (-10 if dtype == torch.float16 else -7)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-6, rtol=ulp)


@pytest.mark.parametrize("m,n,r", [(64, 64, 4), (100, 52, 3), (300, 128, 9)])
@pytest.mark.parametrize("kind", KINDS)
def test_compose_twin_matches_reference_kernel(m, n, r, kind):
    """The host twin of K5's arithmetic (``ref.fedpara_compose_tf32``:
    every factor split into TF32 halves, three passes, fp32 sums)
    against the reference's Pallas compose in interpret mode at the
    reference tests' ragged shapes: fp32 within the file's tolerance."""
    fac = _factors(m + n + r, (), m, n, r, 0.2)
    want = np.asarray(_jax_compose(fac, kind))
    got = ref.fedpara_compose_tf32(*map(torch.from_numpy, fac), kind=kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **COMPOSE_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_compose_twin_matches_reference_kernel(kind):
    """K6's arithmetic on a stack of 3 layers at 96 x 130, r = 5."""
    fac = _factors(11, (3,), 96, 130, 5, 1.0)
    want = np.asarray(_jax_compose(fac, kind))
    got = ref.fedpara_compose_tf32(*map(torch.from_numpy, fac), kind=kind)
    assert tuple(got.shape) == (3, 96, 130)
    np.testing.assert_allclose(got.numpy(), want, **COMPOSE_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_compose_twin_rounds_once_to_fp16(kind):
    """The twin rounds W once, to fp16, at the end, as K5/K6 store it:
    the reference's code or the neighbouring one where the two fp32 sums
    straddle a rounding boundary (as in
    ``test_compose_rounds_once_to_the_requested_type``)."""
    fac = _factors(5, (3,), 100, 52, 3, 0.5)
    want = np.asarray(_jax_compose_to(fac, kind, jnp.float16)
                      ).astype(np.float32)
    got = ref.fedpara_compose_tf32(*map(torch.from_numpy, fac), kind=kind,
                                   out_dtype=torch.float16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                               rtol=2.0 ** -10)


def _compose_f64(fac, kind):
    d = [f.double() for f in fac]
    return ref._hadamard(d[0] @ d[1].mT, d[2] @ d[3].mT, kind)


@pytest.mark.parametrize("r", [1, 337, 505, 1100])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "stacked"])
def test_compose_wrapper_takes_any_rank(lead, r):
    """K5/K6's wrapper takes every rank (γ = 0.3 gives r = 505 at
    qwen3-8b's MLP widths): the card's kernel streams the rank through
    its ring in chunks of 32, and no rank is refused. On the host the
    wrapper is the plain version, and the twin is the kernel's 3xTF32
    arithmetic; both hold to an fp64 compose at fp32 accuracy (1e-5),
    every kind, with and without a leading axis."""
    rng = np.random.default_rng(r + len(lead))
    m, n = 20, 13
    fac = [torch.from_numpy((rng.standard_normal((*lead, d, r)) / np.sqrt(r))
                            .astype(np.float32)) for d in (m, n, m, n)]
    for kind in KINDS:
        want = _compose_f64(fac, kind)
        for got in (ops.fedpara_compose(*fac, kind=kind),
                    ref.fedpara_compose_tf32(*fac, kind=kind)):
            assert got.shape == want.shape and got.dtype == torch.float32
            err = float((got.double() - want).abs().max() / want.abs().max())
            assert err < 1e-5, (kind, err)


def test_compose_launches_count_only_on_the_card():
    ops.reset_launches()
    fac = [torch.from_numpy(a) for a in _factors(1, (2,), 8, 8, 2, 0.5)]
    ops.fedpara_compose(*fac)
    ops.fedpara_compose(*(f[0] for f in fac))
    assert ops.launches()["fedpara_compose"] == 0
    assert ops.launches()["fedpara_compose_stacked"] == 0
    assert {"fedpara_compose", "fedpara_compose_stacked"} <= set(ops.KERNELS)


def test_compose_launcher_checks_its_operands():
    """The CUDA launcher refuses what the kernel does not take before it
    builds or launches anything."""
    x1, y1, x2, y2 = (torch.from_numpy(a)
                      for a in _factors(2, (), 16, 8, 3, 0.5))
    with pytest.raises(ValueError, match="compose kind"):
        fc.fedpara_compose(x1, y1, x2, y2, kind="lowrank")
    with pytest.raises(ValueError, match="float32/float16/bfloat16"):
        fc.fedpara_compose(x1, y1, x2, y2, out_dtype=torch.int8)
    with pytest.raises(ValueError, match="y2"):
        fc.fedpara_compose(x1, y1, x2, y2[:, :2])
    with pytest.raises(ValueError, match=r"\(m, r\) or \(L, m, r\)"):
        fc.fedpara_compose(x1[0], y1, x2, y2)


# ------------------------------------------------------- serving trees

def _reduced(get, kind, layers=2):
    cfg = get("qwen3-8b").reduced()
    return dataclasses.replace(cfg, n_layers=layers, param=dataclasses.replace(
        cfg.param, kind=kind, min_dim_for_factorization=8, gamma=0.5))


@pytest.fixture(scope="module")
def ref_params():
    """Reduced qwen3-8b params the reference initialized, per kind, as
    numpy trees."""
    out = {}
    for kind in ("fedpara", "pfedpara"):
        model = jax_build_model(_reduced(jax_get_arch, kind),
                                JaxOptions(dtype=jnp.float32))
        out[kind] = jax.tree.map(np.asarray,
                                 model.init_params(jax.random.PRNGKey(0)))
    return out


# (dtype, int8) -> (largest |port - reference| relative to the largest
# weight, largest int8 code difference). In fp32 both sides compose in
# fp32: sums in another order. In bf16 the reference's XLA path casts
# the factors to bf16 and rounds both products and their Hadamard
# product to bf16, where the port composes in fp32 and rounds once
# (as the reference's compose kernel does): a few bf16 ulps (2^-8 of
# the largest weight each) apart, so int8 codes up to 127 * 2e-2 plus
# the rounding of each side, 3, apart (1 in fp32: a tie broken apart).
PRECOMPOSE_TOL = {("fp32", False): (1e-5, None), ("bf16", False): (2e-2, None),
                  ("fp32", True): (1e-5, 1), ("bf16", True): (2e-2, 3)}
_DTYPES = {"fp32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("kind", ["fedpara", "pfedpara"])
@pytest.mark.parametrize("dtype,int8", list(PRECOMPOSE_TOL),
                         ids=["fp32", "bf16", "fp32-int8", "bf16-int8"])
def test_precompose_tree_matches_reference(ref_params, kind, dtype, int8):
    params = ref_params[kind]
    pcfg = _reduced(get_arch, kind).param
    tdt, jdt = _DTYPES[dtype]
    rel_tol, code_tol = PRECOMPOSE_TOL[(dtype, int8)]
    want = jax_precompose_tree(params, _reduced(jax_get_arch, kind).param,
                               jdt, int8=int8)
    got = interop.to_numpy(precompose_tree(interop.from_jax_params(params),
                                           pcfg, tdt, int8=int8))
    wf = jax.tree_util.tree_flatten_with_path(want)[0]
    gf = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in wf] == \
        [jax.tree_util.keystr(p) for p, _ in gf]
    for (path, w), (_, g) in zip(wf, gf):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype == np.int8:
            assert g.dtype == np.int8
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= code_tol, path
            continue
        w = w.astype(np.float32)    # bf16 widens to fp32 exactly
        assert np.abs(g - w).max() <= rel_tol * np.abs(w).max(), path


def test_decoder_precompose_serves_like_the_factors(ref_params):
    """``DecoderLM.precompose`` (bf16 W) gives the factor tree's logits
    within bf16 rounding."""
    cfg = _reduced(get_arch, "fedpara")
    model = build_model(cfg, ModelOptions(attn_chunk=8, dtype=torch.float32,
                                          use_kernels=False))
    params = interop.from_jax_params(ref_params["fedpara"])
    tokens = torch.from_numpy(make_token_lm_dataset(2, 8, cfg.vocab_size,
                                                    seed=4)).long()
    outs = []
    for p in (params, model.precompose(params)):
        cache = model.init_cache(2, 8)
        outs.append(model.prefill(p, tokens, cache)[1])
    rel = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
    assert rel < 2e-2


# --------------------------------------------------------- LM training

@pytest.mark.parametrize("n_seq,seq_len,vocab,seed", [
    (48, 16, 151936, 0), (5, 9, 37, 3)])
def test_token_lm_dataset_equals_reference_bitwise(n_seq, seq_len, vocab,
                                                   seed):
    want = jax_token_data(n_seq, seq_len, vocab, seed=seed)
    got = make_token_lm_dataset(n_seq, seq_len, vocab, seed=seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def ref_loss():
    """The reference's loss and gradients on its pFedPara init, reduced
    qwen3-8b with 2 layers, fp32, 4 sequences of 12 tokens."""
    cfg = _reduced(jax_get_arch, "pfedpara")
    model = jax_build_model(cfg, JaxOptions(attn_chunk=8, ssm_chunk=8,
                                            logit_chunk=16,
                                            dtype=jnp.float32))
    params = model.init_params(jax.random.PRNGKey(1))
    toks = jax_token_data(4, 12, cfg.vocab_size, seed=2)
    loss, grads = jax.value_and_grad(model.loss)(params,
                                                 {"tokens": jnp.asarray(toks)})
    return (jax.tree.map(np.asarray, params), toks, float(loss),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_decoder_loss_and_grads_match_reference(ref_loss, use_kernels):
    params_np, toks, want_loss, want_grads = ref_loss
    cfg = _reduced(get_arch, "pfedpara")
    model = build_model(cfg, ModelOptions(attn_chunk=8, logit_chunk=16,
                                          dtype=torch.float32,
                                          use_kernels=use_kernels))
    params = interop.from_jax_params(params_np)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - want_loss) < DEFAULT_ATOL
    want = [np.asarray(g) for g in tree_leaves(want_grads)]
    flat_want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
                 jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    got_tree = interop.to_numpy(_unflatten_like(params, grads))
    flat_got = {jax.tree_util.keystr(p): g for p, g in
                jax.tree_util.tree_flatten_with_path(got_tree)[0]}
    assert sorted(flat_got) == sorted(flat_want) and len(want) == len(grads)
    for k, w in flat_want.items():
        np.testing.assert_allclose(flat_got[k], w, atol=DEFAULT_ATOL,
                                   rtol=DEFAULT_ATOL, err_msg=k)


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it).detach()

    return walk(tree)
