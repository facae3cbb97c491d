"""Flash attention in the PyTorch port against the JAX package.

The same inputs (made from a seed with numpy) go through the JAX
``flash_attention`` — its Pallas kernels in interpret mode on the CPU —
and the port's ``flash_attention``, whose CPU route is the plain versions
of K3-K6 behind the same ``torch.autograd.Function`` the card uses.
Cases are the JAX suite's (t 8-64, d 8-16): plain, causal, key bias,
causal + bias, ``blk_k < blk_q`` ragged causal, one key block (K4), both
layouts, per-head bias and uniformly masked rows.  In f32 the two differ
only in summation order (the Pallas kernels stream blocks, the plain
versions take whole rows): forward within 1e-5, gradients (q, k, v and
the bias) within 1e-4.  ``attention()`` routes the same shapes the same
way in both packages.  The CUDA kernels are held to the plain versions
on the card (``gpu`` marker here, and ``chip_smoke.py``)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the packages' ``flash_attention`` names are the functions; the modules
# are reached by their full paths
fa = importlib.import_module("deeplearning4j_torch.kernels.flash_attention")


def _jax():
    """(jax, jax.numpy, the JAX package's kernels package, its flash
    module) — imported per test, so the ``gpu`` cases also run on a
    machine with a card and no JAX."""
    jax = pytest.importorskip("jax")
    return (jax, jax.numpy,
            importlib.import_module("deeplearning4j_tpu.kernels"),
            importlib.import_module(
                "deeplearning4j_tpu.kernels.flash_attention"))

FWD_TOL, GRAD_TOL = 1e-5, 1e-4

# (name, b, h, t, d, blk_q, blk_k, causal, bias kind, layout)
CASES = [
    ("plain", 2, 2, 64, 16, 16, 16, False, None, "bhtd"),
    ("causal", 2, 2, 64, 16, 16, 16, True, None, "bhtd"),
    ("bias", 2, 2, 64, 16, 16, 16, False, "pad", "bhtd"),
    ("causal_bias", 2, 2, 32, 8, 16, 16, True, "random", "bhtd"),
    ("ragged_causal", 2, 2, 64, 16, 32, 8, True, None, "bhtd"),
    ("single_block", 2, 2, 8, 8, 512, 512, False, None, "bhtd"),
    ("bthd_causal_bias", 2, 3, 64, 16, 16, 16, True, "pad", "bthd"),
    ("bthd_single", 2, 3, 16, 16, 16, 16, True, "random", "bthd"),
    ("heads_bias", 2, 2, 32, 8, 16, 16, True, "heads", "bhtd"),
    ("uniformly_masked", 2, 2, 16, 8, 8, 8, False, "all", "bhtd"),
]


def _inputs(seed, b, h, t, d, bias_kind, layout):
    rng = np.random.default_rng(seed)
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    bias = None
    if bias_kind == "pad":
        bias = np.zeros((b, t), np.float32)
        bias[:, int(t * 0.8):] = -1e9
    elif bias_kind == "random":
        bias = rng.normal(size=(b, t)).astype(np.float32)
    elif bias_kind == "heads":
        bias = rng.normal(size=(b, h, t)).astype(np.float32)
    elif bias_kind == "all":
        bias = np.full((b, t), -1e9, np.float32)
    return q, k, v, g, bias


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_matches_jax_fwd_and_grads(case):
    jax, jnp, jk, jfa = _jax()
    _, b, h, t, d, bq, bk, causal, bias_kind, layout = case
    q, k, v, g, bias = _inputs(len(case[0]), b, h, t, d, bias_kind, layout)
    kw = dict(causal=causal, layout=layout)
    args = [q, k, v] + ([bias] if bias is not None else [])

    def jf(*a):
        return jfa.flash_attention(a[0], a[1], a[2], bq, bk,
                                   bias=a[3] if len(a) > 3 else None, **kw)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(g))

    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fa.flash_attention(targs[0], targs[1], targs[2], bq, bk,
                             bias=targs[3] if len(targs) > 3 else None, **kw)
    out.backward(torch.from_numpy(g))
    assert np.isfinite(out.detach().numpy()).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=FWD_TOL)
    for name, ta, jg in zip("qkvb", targs, jgrads):
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg),
                                   rtol=0, atol=GRAD_TOL, err_msg=name)


# (name, b, h, t, d, blk_q, blk_k, causal, bias kind, layout) past the
# first builds' head dims: dh 160 (zero-padded to the 192 build), 192
# and 256, streaming (K3) and one key block (K4)
WIDE_CASES = [
    ("dh160_causal_bias", 1, 2, 32, 160, 16, 16, True, "random", "bthd"),
    ("dh160_single", 1, 2, 16, 160, 16, 16, False, "pad", "bhtd"),
    ("dh192_causal_bias", 1, 2, 32, 192, 16, 16, True, "random", "bthd"),
    ("dh256_causal", 1, 2, 32, 256, 16, 16, True, None, "bhtd"),
    ("dh256_single_bias", 1, 2, 16, 256, 16, 16, True, "random", "bthd"),
]


@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_wide_head_dims_match_jax_fwd_and_grads(case):
    """The plain route at head dims 160, 192 and 256 (where the CUDA
    route takes the 192 and 256 builds, bf16 on 64-row wgmma tiles)
    against the JAX package's ``flash_attention`` in interpret mode:
    forward within 1e-5, gradients within 1e-4, as at the small head
    dims."""
    test_flash_matches_jax_fwd_and_grads(case)
    assert fa.kernel_head_dim(case[4]) == (256 if case[4] == 256 else 192)


# (name, b, h, t, d, blk_q, blk_k, causal, bias kind, layout) past the
# 256 build: head dims padded to a multiple of 64 (272 padded to 320,
# 320, 384, 448 and 512; bf16 on the card takes the 64-row wgmma forward
# and the panel backward up to 512, f32 the chunked kernels), t 256 in
# two key blocks (K3) and in one (K4)
CHUNKED_CASES = [
    ("dh272_causal_bias", 1, 2, 256, 272, 128, 128, True, "random", "bthd"),
    ("dh320_causal_bias", 1, 2, 256, 320, 128, 128, True, "random", "bhtd"),
    ("dh384_causal_bias", 1, 2, 256, 384, 128, 128, True, "random", "bthd"),
    ("dh512_single_bias", 1, 2, 256, 512, 256, 256, True, "pad", "bthd"),
    ("dh448_causal_bias", 1, 2, 256, 448, 128, 128, True, "random", "bhtd"),
]


@pytest.mark.parametrize("case", CHUNKED_CASES,
                         ids=[c[0] for c in CHUNKED_CASES])
def test_chunked_head_dims_match_jax_fwd_and_grads(case):
    """The plain route past head dim 256 (where the CUDA route takes the
    wide wgmma forward and the panel backward in bf16 up to dh 512 and
    the chunked kernels otherwise, the head dim padded to a multiple of
    64) — the version the card's kernels are held to — against the
    JAX package's ``flash_attention`` in interpret mode, whose kernels
    take any head dim: forward and every gradient within 1e-5 (absolute,
    and relative for the key-bias gradient's sums of dS over 256 queries,
    which reach ~50), causal with a key bias."""
    jax, jnp, jk, jfa = _jax()
    _, b, h, t, d, bq, bk, causal, bias_kind, layout = case
    q, k, v, g, bias = _inputs(d, b, h, t, d, bias_kind, layout)
    kw = dict(causal=causal, layout=layout)

    def jf(*a):
        return jfa.flash_attention(a[0], a[1], a[2], bq, bk, bias=a[3], **kw)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (q, k, v, bias)]
    out = fa.flash_attention(*targs[:3], bq, bk, bias=targs[3], **kw)
    out.backward(torch.from_numpy(g))
    assert fa.kernel_head_dim(d) == -(-d // 64) * 64 > 256
    for name, got, want in zip("oqkvb", [out] + [x.grad for x in targs],
                               [jout] + list(jgrads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_bias_gradient_is_real_and_unscaled():
    """dBias is the sum over queries of dS — no division by 8 survives
    from the TPU's sublane broadcast (the reference's gradient is
    nonzero, and the port's equals it)."""
    jax, jnp, jk, jfa = _jax()
    q, k, v, g, bias = _inputs(5, 2, 2, 32, 8, "random", "bhtd")
    jb = jax.grad(lambda bb: jnp.sum(jnp.asarray(g) * jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 8, 8, bias=bb)))(
        jnp.asarray(bias))
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             8, 8, bias=tb)
    (out * torch.from_numpy(g)).sum().backward()
    assert float(np.abs(np.asarray(jb)).max()) > 1e-3
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=0,
                               atol=GRAD_TOL)


def test_single_switch_is_k4_rounding_point():
    """In bf16 the two plain forwards round P at different points (K3
    before the division by the denominator, K4 after); each stays within
    bf16 rounding of the f32 result, and f32 gives the same answer both
    ways."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 16))
                                .astype(np.float32)) for _ in range(3))
    kw = dict(causal=True, scale=0.25)
    o3, l3 = fa.flash_fwd_reference(q, k, v, **kw)
    o4, l4 = fa.flash_fwd_reference(q, k, v, single=True, **kw)
    torch.testing.assert_close(o3, o4, rtol=0, atol=1e-6)
    torch.testing.assert_close(l3, l4, rtol=0, atol=0)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    b3, _ = fa.flash_fwd_reference(qb, kb, vb, **kw)
    b4, _ = fa.flash_fwd_reference(qb, kb, vb, single=True, **kw)
    assert not torch.equal(b3, b4)
    for o in (b3, b4):
        assert float((o.float() - o3).abs().max()) < 3e-2


@pytest.mark.parametrize("t", [16, 512, 1024])
def test_attention_routes_like_jax(t):
    jax, jnp, jk, jfa = _jax()
    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(size=(1, t, 2, 8)).astype(np.float32)
               for _ in range(3))
    counts = lambda mod: (mod._ROUTE_FLASH.value, mod._ROUTE_XLA.value,
                          mod._ROUTE_XLA_LONG_T.value)
    j0, p0 = counts(jfa), counts(fa)
    jk.reset_route_log()
    fa.reset_route_log()
    jout = jk.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                        layout="bthd")
    out = fa.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                       causal=True, layout="bthd")
    assert fa.route_log() == jk.route_log()
    assert fa.route_log()[0][0] == ("xla" if t < 512 else "flash")
    dj = [a - b for a, b in zip(counts(jfa), j0)]
    dp = [a - b for a, b in zip(counts(fa), p0)]
    assert dp == dj
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=FWD_TOL)


def test_auto_blocks_and_applicability_match_jax():
    jax, jnp, jk, jfa = _jax()
    for t in (256, 512, 768, 1024, 1536, 2048, 4096):
        assert fa._auto_blocks(t) == jfa._auto_blocks(t)
    shapes = [(2, 2, 512, 16), (2, 2, 600, 16), (2, 2, 2048, 128)]
    biases = [None, (2, 512), (2, 2, 512), (2, 1, 512, 512), (512, 512)]
    for shape in shapes:
        for bshape in biases:
            for blk in ((512, 512), (1024, 512), (256, 128), (2048, 2048)):
                bias = None if bshape is None else np.zeros(bshape,
                                                            np.float32)
                want = jfa._flash_applicable(
                    jnp.zeros(shape), jnp.zeros(shape),
                    None if bias is None else jnp.asarray(bias), *blk)
                got = fa._flash_applicable(
                    torch.zeros(shape), torch.zeros(shape),
                    None if bias is None else torch.from_numpy(bias), *blk)
                assert got == want, (shape, bshape, blk)


def test_mask_to_bias_and_fold_match_jax():
    jax, jnp, jk, jfa = _jax()
    mask = np.asarray([[1, 1, 0, 0], [1, 1, 1, 0]], np.float32)
    np.testing.assert_array_equal(
        fa.mask_to_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jfa.mask_to_bias(jnp.asarray(mask))))
    b = np.random.default_rng(0).normal(size=(2, 3, 1, 4)).astype(np.float32)
    want = np.asarray(jfa._fold_bias(jnp.asarray(b), 2, 3, 4))[:, 0, :]
    got = fa._fold_bias(torch.from_numpy(b), 2, 3, 4, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="batch"):
        fa._fold_bias(torch.zeros(4, 4), 2, 3, 4, "cpu")


def test_xla_attention_matches_jax():
    jax, jnp, jk, jfa = _jax()
    q, k, v, _, bias = _inputs(9, 2, 2, 24, 8, "random", "bhtd")
    for kw in ({}, {"causal": True}, {"bias": bias},
               {"causal": True, "bias": bias}):
        jout = jfa.xla_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 **{n: (jnp.asarray(x) if n == "bias" else x)
                                    for n, x in kw.items()})
        out = fa.xla_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **{n: (torch.from_numpy(x) if n == "bias"
                                      else x) for n, x in kw.items()})
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=FWD_TOL)


def test_flash_rejects_ragged_blocks_and_cpu_counts_no_launch():
    q = torch.zeros(1, 1, 48, 16)
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention(q, q, q, blk_q=32, blk_k=32)
    launches = [w.launches for w in (fa.flash_fwd, fa.flash_fwd_single,
                                     fa.flash_bwd_dkdv, fa.flash_bwd_dq)]
    x = torch.randn(1, 2, 32, 16, requires_grad=True)
    fa.flash_attention(x, x, x, 16, 16, causal=True).sum().backward()
    fa.flash_attention(x, x, x, 32, 32).sum().backward()
    assert launches == [w.launches for w in (
        fa.flash_fwd, fa.flash_fwd_single, fa.flash_bwd_dkdv,
        fa.flash_bwd_dq)]


# (name, head dim): the wrappers' zero padding at head dims the kernels
# are not built for, and the tiny Gpt's attention at t 512 (2 heads of
# 16, causal, a padding bias), which takes the flash route (K4) in both
# packages
PAD_CASES = [("dh16", 16), ("dh32", 32), ("dh96", 96),
             ("tiny_gpt_t512", 16)]


@pytest.mark.parametrize("case", PAD_CASES, ids=[c[0] for c in PAD_CASES])
def test_head_dim_padding_is_exact_and_kernel_sized(case, monkeypatch):
    """Every wrapper hands its plain version (and on the card its kernel)
    q, k, v and dO zero-padded to a head dim the kernels are built for
    (64, 128), and slices the padding off.  At dh 16, 32 and 96 the
    forward and backward through the wrappers equal the plain versions
    on the unpadded operands with the explicit scale, to 1e-6 in f32; the
    tiny Gpt's t 512 attention still holds to the JAX package (forward
    1e-5, gradients 1e-4)."""
    name, dh = case
    seen = []   # the head dim each plain call (K3/K4, K5, K6) was handed
    plain = {fn: getattr(fa, fn) for fn in ("flash_fwd_reference",
                                             "flash_bwd_reference")}
    for fn, real in plain.items():
        monkeypatch.setattr(fa, fn, lambda *a, _real=real, **kw: (
            seen.append(a[0].shape[-1]), _real(*a, **kw))[1])
    if name == "tiny_gpt_t512":
        jax, jnp, jk, jfa = _jax()
        q, k, v, g, bias = _inputs(16, 2, 2, 512, dh, "pad", "bthd")
        kw = dict(causal=True, layout="bthd")
        jout, vjp = jax.vjp(lambda *a: jk.attention(*a[:3], bias=a[3], **kw),
                            *(jnp.asarray(x) for x in (q, k, v, bias)))
        jgrads = vjp(jnp.asarray(g))
        targs = [torch.from_numpy(x).requires_grad_(True)
                 for x in (q, k, v, bias)]
        fa.reset_route_log()
        out = fa.attention(*targs[:3], bias=targs[3], **kw)
        out.backward(torch.from_numpy(g))
        assert fa.route_log() == (("flash", 512, dh),)
        assert seen == [64, 64, 64]
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=0, atol=FWD_TOL)
        for n, ta, jg in zip("qkvb", targs, jgrads):
            np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg),
                                       rtol=0, atol=GRAD_TOL, err_msg=n)
        return
    rng = np.random.default_rng(dh)
    b, t, h = 2, 40, 3
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, t, h, dh))
                                    .astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(rng.normal(size=(b * h, t)).astype(np.float32))
    scale = dh ** -0.5
    bh = fa._to_bh
    for causal in (False, True):
        kw = dict(causal=causal, scale=scale)
        o, lse = fa.flash_fwd(q, k, v, bias, **kw)
        delta = fa.row_delta(do, o)
        dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                       need_dbias=True, **kw)
        dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
        assert fa.kernel_head_dim(dh) in fa._KERNEL_DH
        assert seen[-3:] == [fa.kernel_head_dim(dh)] * 3
        ro, rl = plain["flash_fwd_reference"](bh(q), bh(k), bh(v), bias,
                                              **kw)
        rq, rk, rv, rb = plain["flash_bwd_reference"](
            bh(q), bh(k), bh(v), bias, bh(do), lse, delta, **kw)
        for got, want in ((bh(o), ro), (lse, rl), (bh(dq), rq),
                          (bh(dk), rk), (bh(dv), rv), (db, rb)):
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# -- on the card -------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")


def _elem_err(x, r):
    """max |x - r| / (|r| + RMS(r)): each element held to its own size."""
    x, r = x.float(), r.float()
    rms = r.square().mean().sqrt()
    return float(((x - r).abs() / (r.abs() + rms).clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True),
                                              (True, True)])
def test_cuda_kernels_match_plain(dtype, tol, causal, with_bias):
    """K3/K4 forward and K5/K6 backward against the plain versions on
    strided bthd views of a [b, t, 3d] projection at a ragged t.  Each
    element is held to its own size: max |kernel - plain| / (|plain| +
    RMS(plain)) <= tol, an allclose with rtol = tol and atol = tol x the
    output's RMS: the measure of ``chip_smoke.py``'s kernel phase, which
    allows bf16 3e-2 for K3 at t 2048."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, dh = 2, 200, 3, 128
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device="cuda").to(dt)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    bias = (torch.randn((b * h, t), generator=g, device="cuda")
            if with_bias else None)
    do = torch.randn((b, t, h, dh), generator=g, device="cuda").to(dt)
    scale = dh ** -0.5
    err = _elem_err
    bh = lambda x: fa._to_bh(x)
    for single, wrapper in ((False, fa.flash_fwd),
                            (True, fa.flash_fwd_single)):
        n0 = wrapper.launches
        o, lse = wrapper(q, k, v, bias, causal=causal, scale=scale)
        ro, rl = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias,
                                        causal=causal, scale=scale,
                                        single=single)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        assert err(bh(o), ro) <= tol
        assert err(lse, rl) <= 1e-5
    delta = fa.row_delta(do, o)
    dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                   causal=causal, scale=scale,
                                   need_dbias=with_bias)
    dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=causal,
                         scale=scale)
    rq, rk, rv, rb = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias,
                                            bh(do), lse, delta,
                                            causal=causal, scale=scale)
    torch.cuda.synchronize()
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert err(bh(got), want) <= tol
    if with_bias:
        assert err(db, rb) <= tol


def _ragged_bf16(seed, dh, with_bias):
    """bf16 q, k, v, dO on bthd views of a [b, 333, 3d] projection (b 2, 3
    heads) and an optional [b*h, t] key bias, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, t, h = 2, 333, 3
    qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    bias = (torch.randn((b * h, t), generator=g, device="cuda")
            if with_bias else None)
    do = torch.randn((b, t, h, dh), generator=g,
                     device="cuda").to(torch.bfloat16)
    return q, k, v, do, bias


@pytest.mark.gpu
@pytest.mark.parametrize("single", [False, True],
                         ids=["flash_fwd", "flash_fwd_single"])
@pytest.mark.parametrize("dh", [64, 128, 192, 256])
@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True),
                                              (True, True)])
def test_cuda_k3_ragged_t(dh, causal, with_bias, single):
    """K3 (or K4) alone in bf16 at a t that fills neither its 128-row
    query tiles nor its key tiles (128 keys; 64 at dh 192 and 256), with
    and without a key bias, at every built head dim: the interior,
    diagonal, ragged and biased tiles all run.  Held to the plain version
    with the measure of :func:`test_cuda_kernels_match_plain` (O at 2e-2,
    LSE at 1e-5)."""
    _cuda_or_skip()
    q, k, v, _, bias = _ragged_bf16(dh + 2 * causal + with_bias, dh,
                                    with_bias)
    scale = dh ** -0.5
    wrapper = fa.flash_fwd_single if single else fa.flash_fwd
    n0 = wrapper.launches
    o, lse = wrapper(q, k, v, bias, causal=causal, scale=scale)
    bh = fa._to_bh
    ro, rl = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, causal=causal,
                                    scale=scale, single=single)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    assert _elem_err(bh(o), ro) <= 2e-2
    assert _elem_err(lse, rl) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("single", [False, True],
                         ids=["flash_fwd", "flash_fwd_single"])
@pytest.mark.parametrize("dh", [192, 256, 320, 384, 512])
@pytest.mark.parametrize("t", [2000, 2048])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_wide_fwd_causal_long_t(dh, t, with_bias, single):
    """K3 (or K4) in bf16 at head dims 192 and 256 (128-row query tiles,
    64-key tiles) and 320, 384 and 512 (64-row query tiles, 64-key tiles
    at 320 and 32-key ones from 384, the output panels split across the
    two warpgroups), causal at t 2048 and at a ragged t 2000, with and
    without a key bias: each query tile walks up to 64 key tiles —
    interior ones on the branch-free path (no bias), those on its
    diagonal masked, the last one ragged at t 2000, every one biased with
    the bias.  Held as :func:`test_cuda_k3_ragged_t` holds it (O at 2e-2,
    LSE at 1e-5)."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(dh + t + with_bias)
    b, h = 1, 2
    qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    bias = (torch.randn((b * h, t), generator=g, device="cuda")
            if with_bias else None)
    scale = dh ** -0.5
    wrapper = fa.flash_fwd_single if single else fa.flash_fwd
    n0 = wrapper.launches
    o, lse = wrapper(q, k, v, bias, causal=True, scale=scale)
    bh = fa._to_bh
    ro, rl = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, causal=True,
                                    scale=scale, single=single)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    assert _elem_err(bh(o), ro) <= 2e-2
    assert _elem_err(lse, rl) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 192, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True),
                                              (True, True)])
def test_cuda_k5_ragged_t(dh, causal, with_bias):
    """K5 alone in bf16 at the ragged t of :func:`test_cuda_k3_ragged_t`
    (its key blocks — 128 keys, 64 from dh 192 — and query tiles — 64
    rows, 32 past dh 256 — both ragged), on the plain forward's O and
    LSE: dK, dV and dBias held to the plain backward at 2e-2 with the
    same measure."""
    _cuda_or_skip()
    q, k, v, do, bias = _ragged_bf16(7 + dh + 2 * causal + with_bias, dh,
                                     with_bias)
    scale = dh ** -0.5
    bh = fa._to_bh
    b, _, h, _ = q.shape
    o, lse = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, causal=causal,
                                    scale=scale, single=True)
    delta = fa.row_delta(do, fa._from_bh(o, b, h))
    n0 = fa.flash_bwd_dkdv.launches
    dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                   causal=causal, scale=scale,
                                   need_dbias=with_bias)
    _, rk, rv, rb = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias, bh(do),
                                           lse, delta, causal=causal,
                                           scale=scale)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dkdv.launches == n0 + 1
    assert _elem_err(bh(dk), rk) <= 2e-2
    assert _elem_err(bh(dv), rv) <= 2e-2
    if with_bias:
        assert _elem_err(db, rb) <= 2e-2
    else:
        assert db is None


@pytest.mark.gpu
@pytest.mark.parametrize("single", [False, True],
                         ids=["flash_fwd", "flash_fwd_single"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("dh", [16, 32, 96, 160, 192, 256, 272, 320, 384,
                                448, 512])
def test_cuda_kernels_at_padded_head_dims(dh, dtype, tol, single):
    """K3 (or K4), K5 and K6 on the card at head dims past the first
    builds — zero-padded to 64 or 128 (16, 32, 96) or to the 192 build
    (160) by the wrappers, the 192 and 256 builds themselves (bf16 on
    wgmma with 64-row tiles, f32 on FMA tiles), and past 256 (272 padded
    to 320, 320, 384, 448, 512: bf16 on the 64-row wgmma forward and the
    panel backward, f32 on the chunked kernels) — causal with a key bias at
    a ragged t, against the plain versions on the unpadded operands; each
    element held to its own size.  These raised before."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(dh)
    b, t, h = 2, 333, 3
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device="cuda").to(dt)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    bias = torch.randn((b * h, t), generator=g, device="cuda")
    do = torch.randn((b, t, h, dh), generator=g, device="cuda").to(dt)
    kw = dict(causal=True, scale=dh ** -0.5)
    bh = fa._to_bh
    wrapper = fa.flash_fwd_single if single else fa.flash_fwd
    counts = [w.launches for w in (wrapper, fa.flash_bwd_dkdv,
                                   fa.flash_bwd_dq)]
    o, lse = wrapper(q, k, v, bias, **kw)
    delta = fa.row_delta(do, o)
    dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                   need_dbias=True, **kw)
    dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
    ro, rl = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, single=single,
                                    **kw)
    rq, rk, rv, rb = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias,
                                            bh(do), lse, delta, **kw)
    torch.cuda.synchronize()
    assert [w.launches for w in (wrapper, fa.flash_bwd_dkdv,
                                 fa.flash_bwd_dq)] == [n + 1 for n in counts]
    assert o.shape == dq.shape == dk.shape == dv.shape == (b, t, h, dh)
    assert _elem_err(lse, rl) <= 1e-5
    for got, want in ((bh(o), ro), (bh(dq), rq), (bh(dk), rk), (bh(dv), rv),
                      (db, rb)):
        assert _elem_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("single", [False, True],
                         ids=["flash_fwd", "flash_fwd_single"])
@pytest.mark.parametrize("dh", [320, 512])
def test_cuda_wide_fwd_launches_the_wide_kernel(dh, single):
    """One bf16 launch of K3 (or K4) at head dims 320 and 512 under
    ``torch.profiler`` runs ``flash_fwd_bf16_wide_kernel`` and not the
    chunked build, while an f32 launch at the same shape runs
    ``flash_fwd_chunked_kernel``: the route is by dtype and head dim."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile
    q, k, v, _, bias = _ragged_bf16(dh + single, dh, True)
    wrapper = fa.flash_fwd_single if single else fa.flash_fwd
    kw = dict(causal=True, scale=dh ** -0.5)

    def kernels(dtype):
        args = [x.to(dtype) for x in (q, k, v)]
        wrapper(*args, bias, **kw)           # built and configured
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wrapper(*args, bias, **kw)
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages()]

    bf16 = kernels(torch.bfloat16)
    assert any("flash_fwd_bf16_wide_kernel" in n for n in bf16), bf16
    assert not any("flash_fwd_chunked_kernel" in n for n in bf16), bf16
    f32 = kernels(torch.float32)
    assert any("flash_fwd_chunked_kernel" in n for n in f32), f32


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [320, 512])
def test_cuda_wide_bwd_launches_the_panel_kernels(dh):
    """One bf16 launch of K5 and one of K6 at head dims 320 and 512 under
    ``torch.profiler`` run ``flash_bwd_dkdv_panel_kernel`` and
    ``flash_bwd_dq_panel_kernel`` and not the chunked build, while f32
    launches at the same shape run ``flash_bwd_chunked_kernel``: the route
    is by dtype and head dim — the backward twin of
    :func:`test_cuda_wide_fwd_launches_the_wide_kernel`."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do, bias = _ragged_bf16(dh + 5, dh, True)
    kw = dict(causal=True, scale=dh ** -0.5)
    bh = fa._to_bh
    b, _, h, _ = q.shape
    _, lse = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, **kw)

    def kernels(dtype):
        q_, k_, v_, do_ = (x.to(dtype) for x in (q, k, v, do))
        delta = fa.row_delta(do_, q_)   # any f32 [b*h, t] rows will do

        def both():
            fa.flash_bwd_dkdv(q_, k_, v_, bias, do_, lse, delta,
                              need_dbias=True, **kw)
            fa.flash_bwd_dq(q_, k_, v_, bias, do_, lse, delta, **kw)
        both()                               # built and configured
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            both()
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages()]

    bf16 = kernels(torch.bfloat16)
    for name in ("flash_bwd_dkdv_panel_kernel", "flash_bwd_dq_panel_kernel"):
        assert any(name in n for n in bf16), bf16
    assert not any("flash_bwd_chunked_kernel" in n for n in bf16), bf16
    f32 = kernels(torch.float32)
    assert any("flash_bwd_chunked_kernel" in n for n in f32), f32
    assert not any("_panel_kernel" in n for n in f32), f32


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 192, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True),
                                              (True, True), (False, False)])
def test_cuda_k6_ragged_t(dh, causal, with_bias):
    """K6 alone in bf16 at the ragged t of :func:`test_cuda_k3_ragged_t`
    (its query blocks — 128 rows, 64 from dh 192 — and key tiles — 64
    keys, 32 past dh 256 — both ragged), on the plain forward's O and
    LSE: dQ held to the plain backward at 2e-2 with the same measure."""
    _cuda_or_skip()
    q, k, v, do, bias = _ragged_bf16(13 + dh + 2 * causal + with_bias, dh,
                                     with_bias)
    scale = dh ** -0.5
    bh = fa._to_bh
    b, _, h, _ = q.shape
    o, lse = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, causal=causal,
                                    scale=scale, single=True)
    delta = fa.row_delta(do, fa._from_bh(o, b, h))
    n0 = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=causal,
                         scale=scale)
    rq, _, _, _ = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias, bh(do),
                                         lse, delta, causal=causal,
                                         scale=scale)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == n0 + 1
    assert _elem_err(bh(dq), rq) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [192, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("t", [2000, 2048])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_wide_bwd_causal_long_t(dh, t, with_bias):
    """K5 and K6 in bf16 at head dims 192 and 256 (64 x 64 tiles) and
    320, 384, 448 and 512 (64-row blocks, 32-row streamed tiles, the
    output panels split across the warpgroups, K5's dV and dK on separate
    blocks), causal at t 2048 and at a ragged t 2000, with and without a
    key bias — the backward twin of
    :func:`test_cuda_wide_fwd_causal_long_t`: each 64-key block of K5
    walks up to 32 (past 256: 64) query tiles and each 64-row block of K6
    up to 32 (64) key tiles, interior ones branch-free (no bias), the
    diagonal ones masked, the last one ragged at t 2000.  On the plain
    forward's O and LSE, dQ, dK, dV and dBias held to the plain backward
    with the measure of :func:`test_cuda_kernels_match_plain`: at 2e-2
    up to dh 256, and past it at ``chip_smoke.FLASH_TOL``'s bf16 3e-2.
    There a single bf16 rounding of dS * scale that falls the other way
    in an early causal row (few keys, P near 1) moves an output element
    near 0 by one ulp of dS * scale: on an H100 two of the sixteen cases
    read 2.0e-2 to 2.5e-2 (dQ and dK at dh 384, t 2048 and dh 448, t
    2000), where the plain version itself reads 5.9e-2 to 7.9e-2 against
    the same function in f64 (``scripts/flash_bwd_f64.py``); the other
    cases read <= 8e-3."""
    _cuda_or_skip()
    tol = 2e-2 if dh <= 256 else 3e-2
    g = torch.Generator(device="cuda").manual_seed(dh + t + with_bias + 1)
    b, h = 1, 2
    qkv = torch.randn((b, t, 3 * h * dh), generator=g,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    bias = (torch.randn((b * h, t), generator=g, device="cuda")
            if with_bias else None)
    do = torch.randn((b, t, h, dh), generator=g,
                     device="cuda").to(torch.bfloat16)
    kw = dict(causal=True, scale=dh ** -0.5)
    bh = fa._to_bh
    o, lse = fa.flash_fwd_reference(bh(q), bh(k), bh(v), bias, **kw)
    delta = fa.row_delta(do, fa._from_bh(o, b, h))
    counts = [w.launches for w in (fa.flash_bwd_dkdv, fa.flash_bwd_dq)]
    dk, dv, db = fa.flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                   need_dbias=with_bias, **kw)
    dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
    rq, rk, rv, rb = fa.flash_bwd_reference(bh(q), bh(k), bh(v), bias,
                                            bh(do), lse, delta, **kw)
    torch.cuda.synchronize()
    assert [w.launches for w in (fa.flash_bwd_dkdv, fa.flash_bwd_dq)] == [
        n + 1 for n in counts]
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert _elem_err(bh(got), want) <= tol
    if with_bias:
        assert _elem_err(db, rb) <= tol
    else:
        assert db is None
