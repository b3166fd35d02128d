"""The port's FL wire codecs and quantizers held against the reference on
the CPU, mirroring ``tests/test_codecs.py``. On identical numpy inputs
and the same rounding noise (drawn with jax exactly as the reference
draws it: ``fold_in(PRNGKey(round), position)``, split over the leaves
in jax's flattening order, ``uniform - 0.5`` in each leaf's dtype) the
port's wire equals the reference's: delta, fp16 and int8 ``q`` bit for
bit, the int8 scale within 1 ulp, top-k indices equal on tie-free
inputs with the error feedback within 1e-6, low-rank's decoded
``lr_u @ lr_v`` within 1e-5 relative (SVD factors agree only up to
sign); byte counts (``wire_bytes``, ``measured_bytes``,
``quantized_bytes``) equal the reference's integers. The client-stacked
encode (the reference's ``vmap`` written out) is held to the reference's
vmapped encode at the same bounds.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity import make_model
from repro.fl import codecs as jcodecs
from repro.fl import comm as jcomm

from repro_torch import interop
from repro_torch.fl import codecs, comm
from repro_torch.fl.strategies import tree_stack, tree_sub, tree_zeros
from repro_torch.tree import tree_index, tree_leaves, tree_map

SPECS = ["delta", "fp16", "int8", "topk0.2", "delta|fp16", "delta|int8",
         "delta|topk0.1|int8", "topk0.3|fp16", "delta|lowrank0.25",
         "delta|lowrank2|int8", "lowrank3|fp16"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return interop.from_jax_params(_np(tree))


def jax_noise(round_idx, position, tree):
    """The reference's int8 rounding noise for one position's wire tree
    (a port tree), as a port tree: ``fold_in(PRNGKey(round), position)``
    split over the leaves in jax's flattening order (sorted dict keys),
    ``uniform(k, shape, dtype) - 0.5`` in each leaf's dtype."""
    like = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        interop.to_numpy(tree))
    leaves, treedef = jax.tree_util.tree_flatten(like)
    key = jax.random.fold_in(jax.random.PRNGKey(round_idx), position)
    keys = jax.random.split(key, len(leaves))
    out = [np.asarray(jax.random.uniform(k, x.shape, dtype=x.dtype)
                      - jnp.asarray(0.5, x.dtype))
           for x, k in zip(leaves, keys)]
    return interop.from_jax_params(jax.tree_util.tree_unflatten(treedef, out))


def stacked_jax_noise(round_idx, positions):
    """The noise source of a client stack: row i draws at positions[i]."""
    return lambda like: tree_stack([
        jax_noise(round_idx, int(p), tree_index(like, i))
        for i, p in enumerate(positions)])


def _payload(seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"fc1": {"x1": rng.standard_normal((40, 6)).astype(dtype),
                    "y1": rng.standard_normal((30, 6)).astype(dtype)},
            "b1": rng.standard_normal((30,)).astype(dtype)}


def _stacked_payload(C, seed=11):
    rng = np.random.default_rng(seed)
    return {"fc1": {"x1": rng.standard_normal((C, 40, 6)).astype(np.float32),
                    "y1": rng.standard_normal((C, 30, 6)).astype(np.float32)},
            "b1": rng.standard_normal((C, 30)).astype(np.float32)}


def _flat(tree):
    """{path: numpy array} of a reference or port tree."""
    out = {}

    def walk(n, pre):
        if isinstance(n, dict):
            for k in n:
                walk(n[k], f"{pre}/{k}" if pre else str(k))
        elif isinstance(n, torch.Tensor):
            out[pre] = interop.to_numpy(n)
        else:
            out[pre] = np.asarray(n)
    walk(tree, "")
    return out


def _ulp_close(a, b):
    """|a - b| <= 1 ulp elementwise (same dtype)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype
    return np.all(np.abs(a.astype(np.float64) - b.astype(np.float64))
                  <= np.spacing(np.maximum(np.abs(a), np.abs(b))
                                ).astype(np.float64))


def _assert_same_wire(spec, got, want, *, stacked=False):
    """The exact oracle on one encoded wire (module docstring)."""
    g, w = _flat(got), _flat(want)
    if "lowrank" in spec:   # factors agree up to sign: hold the products
        def products(flat):
            prods, rest = {}, {}
            for p, v in flat.items():
                parts = p.split("/")
                if "lr_u" in parts or "lr_v" in parts:
                    i = parts.index("lr_u" if "lr_u" in parts else "lr_v")
                    prods.setdefault("/".join(parts[:i]), {})[
                        "/".join(parts[i:])] = v
                else:
                    rest[p] = v
            return prods, rest
        (gp, gr), (wp, wr) = products(g), products(w)
        assert sorted(gp) == sorted(wp) and sorted(gr) == sorted(wr)

        def dense(node):
            if "lr_u" in node:
                return np.matmul(node["lr_u"], node["lr_v"])
            u = node["lr_u/q"].astype(np.float32) * _bcast(
                node["lr_u/scale"], node["lr_u/q"])
            v = node["lr_v/q"].astype(np.float32) * _bcast(
                node["lr_v/scale"], node["lr_v/q"])
            return np.matmul(u, v)
        for p in gp:
            a, b = dense(gp[p]), dense(wp[p])
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            # int8 factors round their own (sign-dependent) values
            assert rel < (2e-2 if "int8" in spec else 1e-5), (spec, p, rel)
        g, w = gr, wr
    assert sorted(g) == sorted(w), spec
    for p in w:
        assert g[p].dtype == w[p].dtype and g[p].shape == w[p].shape, p
        if p.endswith("scale"):
            assert _ulp_close(g[p], w[p]), (spec, p)
        else:
            assert g[p].tobytes() == w[p].tobytes(), (spec, p)


def _bcast(scale, q):
    scale = np.asarray(scale)
    return scale.reshape(scale.shape + (1,) * (q.ndim - scale.ndim))


# ------------------------------------------------------------ stage trips

def test_identity_codec_is_noop():
    payload = _t(_payload())
    codec = codecs.make_codec("fp32")
    assert codec.is_identity and not codec.has_ef and not codec.has_delta
    dec, ef = codec.encode_decode(payload)
    assert dec is payload and ef is None
    assert codec.wire_bytes(payload) == \
        jcodecs.make_codec("fp32").wire_bytes(_payload())


def test_fp16_and_int8_roundtrip_bounds():
    payload = _t(_payload())
    dec, _ = codecs.make_codec("fp16").encode_decode(payload)
    assert all(float((a - b).abs().max()) < 2e-3 and a.dtype == torch.float32
               for a, b in zip(tree_leaves(dec), tree_leaves(payload)))
    dec, _ = codecs.make_codec("int8").encode_decode(
        payload, noise=lambda like: jax_noise(0, 0, like))
    for a, b in zip(tree_leaves(dec), tree_leaves(payload)):
        assert float((a - b).abs().max()) < float(b.abs().max()) / 64


def test_topk_keeps_exactly_k_largest():
    payload = _t(_payload())
    frac = 0.2
    codec = codecs.make_codec(f"topk{frac}")
    wire, ef = codec.encode(payload, ef=codec.ef_init(payload))
    for w, x in zip(tree_leaves(wire), tree_leaves(payload)):
        k = max(1, math.ceil(frac * x.numel()))
        assert int((w != 0).sum()) == k
        kept = np.sort(np.abs(w.numpy().ravel()))[-k:]
        top = np.sort(np.abs(x.numpy().ravel()))[-k:]
        np.testing.assert_array_equal(kept, top)
    for e, x, w in zip(tree_leaves(ef), tree_leaves(payload),
                       tree_leaves(wire)):
        assert torch.equal(e, x - w)


def test_lowrank_reconstructs_lowrank_input():
    rng = np.random.default_rng(0)
    x = {"w": torch.from_numpy((rng.standard_normal((24, 3))
                                @ rng.standard_normal((3, 18))).astype(
                                    np.float32))}
    dec, _ = codecs.make_codec("lowrank3").encode_decode(x)
    assert float((dec["w"] - x["w"]).abs().max()) < 1e-4
    dec1, _ = codecs.make_codec("lowrank1").encode_decode(x)
    assert float((dec1["w"] - x["w"]).abs().max()) > 1e-2
    wire, _ = codecs.make_codec("lowrank0.25").encode(_t(_payload()))
    assert codecs._is_lr_node(wire["fc1"]["x1"])
    assert torch.equal(wire["b1"], _t(_payload())["b1"])   # 1-D passes


def test_error_feedback_reduces_longrun_bias():
    """Accumulated EF-top-k transmissions converge to the true signal;
    naive top-k keeps dropping the same small coordinates."""
    x = {"g": torch.linspace(0.1, 1.0, 50)}
    codec = codecs.make_codec("topk0.2")
    T = 20
    naive, with_ef = tree_zeros(x), tree_zeros(x)
    ef = codec.ef_init(x)
    for _ in range(T):
        dec_naive, _ = codec.encode_decode(x)
        naive = tree_map(torch.add, naive, dec_naive)
        dec_ef, ef = codec.encode_decode(x, ef=ef)
        with_ef = tree_map(torch.add, with_ef, dec_ef)
    bias_naive = float((naive["g"] - T * x["g"]).abs().max()) / T
    bias_ef = float((with_ef["g"] - T * x["g"]).abs().max()) / T
    assert bias_naive > 0.05
    assert bias_ef < bias_naive / 5


# --------------------------------------------------------------- parsing

@pytest.mark.parametrize("spec", [
    "", "fp32", "none", "identity", "delta", "topk0.1", "lowrank4",
    "lowrank0.25", "int8", "fp16", "delta|topk0.1|int8",
    "delta|lowrank2|fp16", " delta | fp32 | int8 ", "fp32|delta",
    "int8|delta", "topk0.1|lowrank4", "topk0.1|topk0.2", "gzip",
    "topk1.5", "topk0", "lowrank0", "lowrank-1", "delta|delta",
    "fp16|int8"])
def test_spec_grammar_and_errors_equal_reference(spec):
    try:
        want = jcodecs.make_codec(spec)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            codecs.make_codec(spec)
        return
    got = codecs.make_codec(spec)
    assert got.spec == want.spec
    assert [(s.kind, s.param) for s in got.stages] == \
        [(s.kind, s.param) for s in want.stages]
    for prop in ("is_identity", "has_ef", "has_delta", "agg_linear"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_stage_helpers_equal_reference():
    for shape in [(), (7,), (40, 6), (3, 5, 7), (1, 1), (784, 40)]:
        for frac in (0.01, 0.1, 0.25, 0.5, 1.0):
            assert codecs._topk_count(shape, frac) == \
                jcodecs._topk_count(shape, frac)
    for shape in [(40, 6), (6, 40), (784, 40), (10, 4), (2, 2), (30,)]:
        for param in (0.25, 0.5, 1, 2, 3, 5, 40):
            assert codecs._lowrank_eligible(shape, param) == \
                jcodecs._lowrank_eligible(shape, param)
            if len(shape) == 2:
                assert codecs._lowrank_rank(shape, param) == \
                    jcodecs._lowrank_rank(shape, param)


# ---------------------------------------------------- the exact oracle

@pytest.mark.parametrize("spec", SPECS)
def test_encode_equals_reference_on_identical_inputs(spec):
    x = _payload()
    ref = jax.tree.map(lambda a: 0.5 * a, _payload(8))
    jc, c = jcodecs.make_codec(spec), codecs.make_codec(spec)
    jef = jc.ef_init(x)
    if jef is not None:
        jef = jax.tree.map(lambda a: 0.1 * a, _payload(9))
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want, want_ef = jc.encode(jax.tree.map(jnp.asarray, x),
                              ref=jax.tree.map(jnp.asarray, ref), ef=jef,
                              key=key)
    got, got_ef = c.encode(_t(x), ref=_t(ref),
                           ef=None if jef is None else _t(jef),
                           noise=lambda like: jax_noise(3, 5, like))
    _assert_same_wire(spec, got, want)
    assert (got_ef is None) == (want_ef is None)
    if want_ef is not None:
        for p, v in _flat(want_ef).items():
            np.testing.assert_allclose(_flat(got_ef)[p], v, atol=1e-6)
    dec = c.decode(got, ref=_t(ref))
    jdec = jc.decode(want, ref=jax.tree.map(jnp.asarray, ref))
    for p, v in _flat(jdec).items():
        np.testing.assert_allclose(_flat(dec)[p], v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spec", ["topk0.2", "delta|topk0.1|int8",
                                  "topk0.05|fp16"])
def test_topk_indices_equal_reference(spec):
    x = _payload(21)
    jc, c = jcodecs.make_codec(spec), codecs.make_codec(spec)
    ref = tree_zeros(_t(x))
    want, _ = jc.encode(jax.tree.map(jnp.asarray, x), ref=_np(ref),
                        ef=jc.ef_init(x), key=jax.random.PRNGKey(0))
    got, _ = c.encode(_t(x), ref=ref, ef=c.ef_init(_t(x)),
                      noise=lambda like: jax_noise(0, 0, like))
    wd = _flat(jc.decode(want, ref=_np(ref)))
    gd = _flat(c.decode(got, ref=ref))
    for p, v in wd.items():
        assert np.array_equal(np.nonzero(gd[p].ravel())[0],
                              np.nonzero(v.ravel())[0]), (spec, p)


@pytest.mark.parametrize("spec", ["delta|topk0.25|int8", "delta|fp16",
                                  "int8", "delta|lowrank0.25",
                                  "delta|lowrank2|int8"])
def test_stacked_encode_equals_reference_vmap(spec):
    """The client-stacked encode (EF stacked, noise per position) against
    the reference's vmapped encode on the same stacked uploads."""
    C, rnd = 3, 2
    positions = [0, 1, 2]
    up = _stacked_payload(C)
    ref = _payload(12)
    jc, c = jcodecs.make_codec(spec), codecs.make_codec(spec)
    ef = (jax.tree.map(lambda a: 0.05 * a, _stacked_payload(C, 13))
          if jc.has_ef else None)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(rnd), p)
                      for p in positions])
    jref = jax.tree.map(jnp.asarray, ref)
    want, want_ef = jax.vmap(
        lambda u, e, k: jc.encode(u, ref=jref, ef=e, key=k))(
            jax.tree.map(jnp.asarray, up),
            None if ef is None else jax.tree.map(jnp.asarray, ef), keys)
    got, got_ef = c.encode(_t(up), ref=_t(ref),
                           ef=None if ef is None else _t(ef),
                           noise=stacked_jax_noise(rnd, positions),
                           stacked=True)
    _assert_same_wire(spec, got, want, stacked=True)
    if want_ef is not None:
        for p, v in _flat(want_ef).items():
            np.testing.assert_allclose(_flat(got_ef)[p], v, atol=1e-6)
    # the stacked encode equals the per-client encode row by row
    for i, p in enumerate(positions):
        one, one_ef = c.encode(
            tree_index(_t(up), i), ref=_t(ref),
            ef=None if ef is None else tree_index(_t(ef), i),
            noise=lambda like, p=p: jax_noise(rnd, p, like))
        rows = _flat(tree_map(lambda a: a[i], got))
        for path, v in _flat(one).items():
            if "lr_" not in path:
                assert v.tobytes() == rows[path].tobytes(), (spec, path)


def test_int8_scale_is_per_client_when_stacked():
    up = _t(_stacked_payload(4))
    up["b1"][2] *= 100.0
    wire = comm.quantize_int8(up, tree_map(torch.zeros_like, up),
                              stacked=True)
    s = wire["b1"]["scale"]
    assert s.shape == (4,)
    np.testing.assert_allclose(s.numpy(), up["b1"].abs().amax(1).numpy()
                               / 127.0, rtol=1e-6)
    dec = comm.dequantize_int8(wire)
    for get in (lambda t: t["fc1"]["x1"], lambda t: t["fc1"]["y1"],
                lambda t: t["b1"]):
        err = (get(dec) - get(up)).abs().reshape(4, -1).amax(1)
        assert bool((err <= get(wire)["scale"] * 0.5 + 1e-7).all())


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_quantizers_equal_reference(dtype):
    x = _payload(3, dtype)
    jx = jax.tree.map(jnp.asarray, x)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 1)
    want = jcomm.quantize_int8(jx, key)
    got = comm.quantize_int8(_t(x), jax_noise(4, 1, _t(x)))
    _assert_same_wire("int8", got, want)
    for p, v in _flat(jcomm.dequantize_int8(want)).items():
        assert _flat(comm.dequantize_int8(got))[p].tobytes() == v.tobytes()
    _assert_same_wire("fp16", comm.quantize_fp16(_t(x)),
                      jcomm.quantize_fp16(jx))
    for p, v in _flat(jcomm.dequantize_fp16(jcomm.quantize_fp16(jx))).items():
        assert _flat(comm.quantize_dequantize(_t(x), "fp16"))[p].tobytes() \
            == v.tobytes()
    for p, v in _flat(jcomm.quantize_dequantize(jx, "int8", key)).items():
        got_rt = comm.quantize_dequantize(_t(x), "int8",
                                          jax_noise(4, 1, _t(x)))
        assert _flat(got_rt)[p].tobytes() == v.tobytes()
    for scheme in ("int8", "fp16", "fp32"):
        for tree, jtree in ((_t(x), jx), (got, want),
                            ({"a": got, "b": _t(x)}, {"a": want, "b": jx})):
            assert comm.quantized_bytes(tree, scheme) == \
                jcomm.quantized_bytes(jtree, scheme), scheme
    assert comm.quantize_dequantize(_t(x), "fp32") is not None


def test_default_int8_noise_is_uniform_and_unbiased():
    """The server's default noise (a generator seeded from round and
    position) is U[-0.5, 0.5): every |dequant - x| <= scale, the mean
    error near 0. The int8 stage raises without a noise source; the
    round trip alone keeps the reference's seeded-0 default."""
    x = {"w": torch.randn(200_000, generator=torch.Generator().manual_seed(1))}
    noise = comm.position_noise(x, 3, 2, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(noise), tree_leaves(comm.position_noise(x, 3, 2, "cpu"))))
    assert float(noise["w"].min()) >= -0.5 and float(noise["w"].max()) < 0.5
    wire = comm.quantize_int8(x, noise)
    err = comm.dequantize_int8(wire)["w"] - x["w"]
    scale = float(wire["w"]["scale"])
    assert float(err.abs().max()) <= scale
    sigma = scale / math.sqrt(12.0) / math.sqrt(err.numel())
    assert abs(float(err.double().mean())) < 4 * sigma
    for bad in (None, noise):
        with pytest.raises(ValueError, match="noise source"):
            codecs.make_codec("int8").encode(x, noise=bad)
    with pytest.raises(ValueError, match="rounding noise"):
        comm.quantize_int8(x, None)
    a = comm.quantize_dequantize(x, "int8")
    b = comm.quantize_dequantize(x, "int8")
    assert torch.equal(a["w"], b["w"])   # seeded: reproducible


# ------------------------------------------------------------ wire bytes

def _byte_trees():
    """The MLP's fedpara tree, the pFedPara global half, and fp16 / bf16
    leaves (reference trees)."""
    _, fed, _ = make_model("fedpara")
    _, pfed, _ = make_model("pfedpara")
    glob, _ = jcomm.split_pfedpara(pfed)
    x = _payload(5)
    return {"fedpara": fed, "pfedpara_global": glob,
            "fp16": jax.tree.map(lambda a: jnp.asarray(a, jnp.float16), x),
            "bf16": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), x)}


BYTE_SPECS = ["", "fp16", "int8", "delta", "topk0.1", "topk0.3|fp16",
              "delta|topk0.1|int8", "lowrank2", "lowrank0.25|int8",
              "delta|lowrank2|int8", "delta|lowrank0.5|fp16", "topk1.0"]


@pytest.mark.parametrize("tree_name", ["fedpara", "pfedpara_global", "fp16",
                                       "bf16"])
def test_wire_and_measured_bytes_equal_reference(tree_name):
    jtree = _byte_trees()[tree_name]
    tree = _t(jtree)
    for spec in BYTE_SPECS:
        jc, c = jcodecs.make_codec(spec), codecs.make_codec(spec)
        want = jc.wire_bytes(jtree)
        assert c.wire_bytes(tree) == want, (tree_name, spec)
        assert c.ef_nbytes(tree) == jc.ef_nbytes(jtree), spec
        if tree_name in ("fp16", "bf16") and "lowrank" in spec:
            continue   # neither side has a half-precision SVD on the host
        # the reference's own tests hold its measured_bytes to wire_bytes
        frac = next((s.param for s in c.stages if s.kind == "topk"), None)
        wire, _ = c.encode(tree, ref=tree_zeros(tree), ef=c.ef_init(tree),
                           noise=lambda like: jax_noise(0, 0, like))
        kw = {"topk_frac": frac} if frac is not None else {}
        assert codecs.measured_bytes(wire, **kw) == want, (tree_name, spec)


# --------------------------------------------- encoded-form aggregation

@pytest.mark.parametrize("spec", ["int8", "fp16", "delta|int8",
                                  "delta|topk0.3|int8", "topk0.5",
                                  "delta|lowrank2|int8", "delta|lowrank0.25"])
def test_encode_for_agg_equals_reference(spec):
    """decode(wire) == linear(agg_wire) + delta-ref for every codec (the
    low-rank product composed per client), and the agg wire equals the
    reference's."""
    x = _payload(31)
    ref = jax.tree.map(lambda a: 0.3 * a, x)
    jc, c = jcodecs.make_codec(spec), codecs.make_codec(spec)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 2)
    want, _ = jc.encode_for_agg(jax.tree.map(jnp.asarray, x),
                                ref=jax.tree.map(jnp.asarray, ref),
                                ef=jc.ef_init(x), key=key)
    noise = lambda like: jax_noise(9, 2, like)   # noqa: E731
    got, _ = c.encode_for_agg(_t(x), ref=_t(ref), ef=c.ef_init(_t(x)),
                              noise=noise)
    dec, _ = c.encode_decode(_t(x), ref=_t(ref), ef=c.ef_init(_t(x)),
                             noise=noise)
    assert c.agg_linear == jc.agg_linear
    if c.agg_linear:
        _assert_same_wire(spec, got, want)
        lin = comm.dequantize_fp16(comm.dequantize_int8(got)) \
            if "int8" in spec or "fp16" in spec else got
    else:
        for p, v in _flat(want).items():   # dense per-client products
            g = _flat(got)[p]
            assert np.linalg.norm(g - v) <= (
                2e-2 if "int8" in spec else 1e-5) * np.linalg.norm(v), p
        lin = got
    fin = c.agg_finalize(lin, ref=_t(ref))
    for p, v in _flat(dec).items():
        np.testing.assert_allclose(_flat(fin)[p], v, atol=1e-5)


def test_agg_finalize_pinned_equals_reference():
    mean = _payload(41)
    refs = {3: _payload(42), 1: _payload(43), 7: _payload(44)}
    coefs = {3: 0.25, 1: 0.75, 7: 0.0}
    want = jcodecs.Codec.agg_finalize_pinned(
        jax.tree.map(jnp.asarray, mean),
        {d: jax.tree.map(jnp.asarray, r) for d, r in refs.items()}, coefs)
    got = codecs.Codec.agg_finalize_pinned(
        _t(mean), {d: _t(r) for d, r in refs.items()}, coefs)
    for p, v in _flat(want).items():
        assert _flat(got)[p].tobytes() == v.tobytes(), p
    one = codecs.Codec.agg_finalize_pinned(_t(mean), {0: _t(refs[3])},
                                           {0: 1.0})
    fin = codecs.make_codec("delta").agg_finalize(_t(mean), ref=_t(refs[3]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(one),
                                                 tree_leaves(fin)))


def test_delta_wire_carries_the_difference():
    x, ref = _t(_payload()), _t(_payload(2))
    codec = codecs.make_codec("delta")
    wire, _ = codec.encode(x, ref=ref)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(wire), tree_leaves(tree_sub(x, ref))))
    dec, _ = codec.encode_decode(x, ref=ref)
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(dec), tree_leaves(x))) < 1e-6
    with pytest.raises(ValueError, match="reference tree"):
        codec.encode(x)
