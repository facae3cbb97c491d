"""Paged decode and verify attention in the PyTorch port against the JAX
package.

Same inputs (made from a seed with numpy) through the JAX reference
(``paged_decode_attention_reference`` / ``paged_verify_attention_
reference``), the JAX Pallas kernel in interpret mode, and the port's
plain version.  In f32 the port's plain version repeats the JAX
reference's ops, so the two agree to 1e-6 (float rounding of the same
sums on two backends); the Pallas kernel streams the softmax block by
block, a different summation order — also within 1e-6 at these sizes.
The CUDA kernels themselves are held to the plain versions on the card
(``gpu`` marker here, and ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.kernels import paged_attention as pa  # noqa: E402


def _jnp():
    """jax.numpy, imported per test, so the ``gpu`` cases also run on a
    machine with a card and no JAX."""
    return pytest.importorskip("jax").numpy


def _paged_fixture(seed=0, B=3, h=4, dh=8, bs=4, mb=4, nb=9):
    """The JAX test suite's ``_paged_fixture`` shapes, as numpy."""
    rng = np.random.default_rng(seed)
    kpool = rng.normal(size=(nb, h, bs, dh)).astype(np.float32)
    vpool = rng.normal(size=(nb, h, bs, dh)).astype(np.float32)
    tbl = rng.integers(1, nb, (B, mb)).astype(np.int32)
    pos = np.asarray([3, 7, 13], np.int32)
    q = rng.normal(size=(B, h, dh)).astype(np.float32)
    return q, kpool, vpool, tbl, pos, 1.0 / dh ** 0.5


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_reference_and_pallas_interpret(seed):
    jnp = _jnp()
    from deeplearning4j_tpu.kernels.paged_attention import (
        _paged_decode_pallas, paged_decode_attention_reference)
    q, kp, vp, tbl, pos, scale = _paged_fixture(seed)
    ref = np.asarray(paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(pos), scale))
    pallas = np.asarray(_paged_decode_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(pos), scale))
    out = pa.paged_decode_attention_reference(*_torch(q, kp, vp, tbl, pos),
                                              scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-6)


def test_gather_matches_jax():
    jnp = _jnp()
    from deeplearning4j_tpu.kernels import paged_gather as jax_gather
    q, kp, vp, tbl, pos, scale = _paged_fixture()
    ref = np.asarray(jax_gather(jnp.asarray(kp), jnp.asarray(tbl)))
    out = pa.paged_gather(*_torch(kp, tbl)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_plain_is_bitwise_stripe_math():
    """The plain version IS the stripe decode step's math on the table's
    gathered view — the self-consistency the server's parity rests on."""
    q, kp, vp, tbl, pos, scale = _paged_fixture()
    q, kp, vp, tbl, pos = _torch(q, kp, vp, tbl, pos)
    ref = pa.paged_decode_attention_reference(q, kp, vp, tbl, pos, scale)
    kl, vl = pa.paged_gather(kp, tbl), pa.paged_gather(vp, tbl)
    L = kl.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, None, :], kl).float()
    s = s * scale
    valid = (torch.arange(L)[None, :] <= pos.long()[:, None])[:, None,
                                                               None, :]
    s = torch.where(valid, s, torch.tensor(-1e9))
    p = torch.softmax(s, -1).to(vl.dtype)
    stripe = torch.einsum("bhqk,bhkd->bhqd", p, vl)[:, :, 0]
    assert torch.equal(ref, stripe)


def test_wrapper_routes_cpu_to_plain_and_counts():
    q, kp, vp, tbl, pos, scale = _paged_fixture()
    q, kp, vp, tbl, pos = _torch(q, kp, vp, tbl, pos)
    route = telemetry.get_registry().counter(
        "paged_route_total", labelnames=("path",)).labels(path="reference")
    r0, l0 = route.value, pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, kp, vp, tbl, pos)   # default scale
    assert torch.equal(out, pa.paged_decode_attention_reference(
        q, kp, vp, tbl, pos, scale))
    assert route.value == r0 + 1
    assert pa.paged_decode_attention.launches == l0   # no kernel on CPU


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "shape",
                                 "contiguous", "pos_shape"])
def test_wrapper_rejects_bad_operands(bad):
    q, kp, vp, tbl, pos, _ = _paged_fixture()
    q, kp, vp, tbl, pos = _torch(q, kp, vp, tbl, pos)
    if bad == "dtype":
        q = q.double()
    elif bad == "table_dtype":
        tbl = tbl.long()
    elif bad == "shape":
        kp = kp[:, :2]
    elif bad == "contiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        pos = pos[:2]
    with pytest.raises(ValueError, match="paged_decode_attention"):
        pa.paged_decode_attention(q, kp, vp, tbl, pos)


def _verify_fixture(seed, W, bs, B=3, h=4, dh=8, mb=4):
    """Verify-chunk shapes: slot 0 at the start, slot 1 mid-table, slot 2
    with its chunk running past the table's end (rows near max_len)."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * mb
    kpool = rng.normal(size=(nb, h, bs, dh)).astype(np.float32)
    vpool = rng.normal(size=(nb, h, bs, dh)).astype(np.float32)
    tbl = np.stack([rng.permutation(np.arange(1, nb))[:mb]
                    for _ in range(B)]).astype(np.int32)
    pos0 = np.asarray([0, mb * bs // 2 - 1, mb * bs - 2], np.int32)
    q = rng.normal(size=(B, W, h, dh)).astype(np.float32)
    return q, kpool, vpool, tbl, pos0, 1.0 / dh ** 0.5


@pytest.mark.parametrize("W", [1, 3, 5, 17, 20])
@pytest.mark.parametrize("bs", [4, 8])
def test_verify_plain_matches_jax_reference_and_pallas_interpret(W, bs):
    jnp = _jnp()
    from deeplearning4j_tpu.kernels.paged_attention import (
        _paged_verify_pallas, paged_verify_attention_reference)
    q, kp, vp, tbl, pos0, scale = _verify_fixture(10 * W + bs, W, bs)
    args = [jnp.asarray(a) for a in (q, kp, vp, tbl, pos0)]
    ref = np.asarray(paged_verify_attention_reference(*args, scale))
    pallas = np.asarray(_paged_verify_pallas(*args, scale))
    out = pa.paged_verify_attention_reference(
        *_torch(q, kp, vp, tbl, pos0), scale).numpy()
    assert out.shape == q.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-6)


def test_verify_plain_rows_are_decode_reads():
    """Row j of the plain verify read IS the plain decode read at
    position pos0 + j (bitwise): the per-row unroll of the reference."""
    q, kp, vp, tbl, pos0, scale = _verify_fixture(4, 3, 4)
    q, kp, vp, tbl, pos0 = _torch(q, kp, vp, tbl, pos0)
    out = pa.paged_verify_attention_reference(q, kp, vp, tbl, pos0, scale)
    for j in range(q.shape[1]):
        dec = pa.paged_decode_attention_reference(
            q[:, j].contiguous(), kp, vp, tbl, pos0 + j, scale)
        assert torch.equal(out[:, j], dec)


def test_verify_wrapper_routes_cpu_to_plain_and_counts():
    q, kp, vp, tbl, pos0, scale = _verify_fixture(5, 5, 8)
    q, kp, vp, tbl, pos0 = _torch(q, kp, vp, tbl, pos0)
    route = telemetry.get_registry().counter(
        "paged_route_total", labelnames=("path",)).labels(path="reference")
    r0, l0 = route.value, pa.paged_verify_attention.launches
    out = pa.paged_verify_attention(q, kp, vp, tbl, pos0)  # default scale
    assert torch.equal(out, pa.paged_verify_attention_reference(
        q, kp, vp, tbl, pos0, scale))
    assert route.value == r0 + 1
    assert pa.paged_verify_attention.launches == l0   # no kernel on CPU


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "shape", "rank",
                                 "contiguous", "pos_shape", "device"])
def test_verify_wrapper_rejects_bad_operands(bad):
    q, kp, vp, tbl, pos0, _ = _verify_fixture(6, 3, 4)
    q, kp, vp, tbl, pos0 = _torch(q, kp, vp, tbl, pos0)
    if bad == "dtype":
        kp, vp = kp.double(), vp.double()
    elif bad == "table_dtype":
        tbl = tbl.long()
    elif bad == "shape":
        kp = kp[:, :2].contiguous()
    elif bad == "rank":
        q = q[:, 0].contiguous()               # a decode-shaped q
    elif bad == "contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "pos_shape":
        pos0 = pos0[:2]
    else:
        pos0 = pos0.to("meta")
    with pytest.raises(ValueError, match="paged_verify_attention"):
        pa.paged_verify_attention(q, kp, vp, tbl, pos0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_plain(dtype, tol):
    """On the card: the CUDA kernel against the plain version at the
    serving path's shapes (f32: summation order only; bf16: the plain
    version's bf16 rounding points)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    B, h, dh, bs, mb = 8, 6, 128, 16, 64
    nb = 1 + B * mb
    kp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    vp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    q = torch.randn((B, h, dh), generator=g, device="cuda").to(dt)
    tbl = (torch.randperm(nb - 1, generator=g, device="cuda").reshape(
        B, mb) + 1).to(torch.int32)
    pos = torch.tensor([0, 15, 16, 17, 511, 1023, 700, 250],
                       dtype=torch.int32, device="cuda")
    l0 = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, kp, vp, tbl, pos)
    ref = pa.paged_decode_attention_reference(q, kp, vp, tbl, pos,
                                              1.0 / dh ** 0.5)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == l0 + 1
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("B,h,capacity", [(8, 6, 1024), (8, 6, 512),
                                           (1, 1, 4096), (64, 12, 2048),
                                           (4, 4, 64), (2, 3, 40)])
def test_decode_split_rows_cover_the_table(B, h, capacity):
    """The decode kernel's chunk: a multiple of 32 rows; the splits cover
    the table's capacity with none wholly past it; at every context the
    live splits (those starting below it) each cover >= 1 row and
    together exactly the context."""
    C = pa.decode_split_rows(B, h, capacity)
    S = -(-capacity // C)
    assert C >= 32 and C % 32 == 0
    assert (S - 1) * C < capacity <= S * C
    for n_ctx in sorted({1, C - 1, C, C + 1, capacity - 1, capacity}):
        if not 1 <= n_ctx <= capacity:
            continue
        rows = [range(s * C, min(n_ctx, (s + 1) * C)) for s in range(S)
                if s * C < n_ctx]
        assert all(len(r) >= 1 for r in rows)
        assert [j for r in rows for j in r] == list(range(n_ctx))


def test_decode_split_rows_fill_the_card_at_the_serving_shapes():
    """At the serving path's shapes (8 slots, 6 heads, 64-entry tables of
    16 rows) the live (slot, head, split) blocks number >= 2 per SM of
    an H100 at ~450-row contexts and at ``chip_smoke.py``'s timing
    contexts, with no read of the positions."""
    B, h, cap, sms = 8, 6, 1024, 132
    C = pa.decode_split_rows(B, h, cap, sms)
    for ctx in ([450] * B, [101, 228, 355, 482, 609, 736, 863, 990]):
        live = h * sum(-(-n // C) for n in ctx)
        assert live >= 2 * sms, (C, ctx, live)


def _scaled_err(x, r):
    """max |x - r| / (|r| + RMS(r)): each element held to its own size."""
    x, r = x.float(), r.float()
    rms = r.square().mean().sqrt()
    return float(((x - r).abs() / (r.abs() + rms).clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_cuda_kernel_split_edges(dtype, tol):
    """On the card: the split decode kernel at positions on its split
    edges (C - 1, C, C + 1, the table's last row) and with slots that fill
    only the first split beside slots that fill every split; each element
    held to its own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    g = torch.Generator(device="cuda").manual_seed(2)
    dt = getattr(torch, dtype)
    B, h, dh, bs, mb = 8, 6, 128, 16, 64
    nb = 1 + B * mb
    C = pa.decode_split_rows(B, h, mb * bs, torch.cuda.get_device_properties(
        0).multi_processor_count)
    kp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    vp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    q = torch.randn((B, h, dh), generator=g, device="cuda").to(dt)
    tbl = (torch.randperm(nb - 1, generator=g, device="cuda").reshape(
        B, mb) + 1).to(torch.int32)
    for positions in ([C - 1, C, C + 1, mb * bs - 1, 0, 2 * C - 1, 2 * C,
                       2 * C + 1],
                      [0, mb * bs - 1, C - 1, mb * bs - 1, 5, mb * bs - 1,
                       C // 2, mb * bs - 2]):
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        out = pa.paged_decode_attention(q, kp, vp, tbl, pos)
        ref = pa.paged_decode_attention_reference(q, kp, vp, tbl, pos,
                                                  1.0 / dh ** 0.5)
        torch.cuda.synchronize()
        assert _scaled_err(out, ref) <= tol, positions


@pytest.mark.parametrize("B,W,h,capacity", [
    (8, 5, 6, 1024), (8, 17, 6, 1024), (1, 1, 1, 4096), (64, 5, 12, 2048),
    (4, 20, 4, 64), (2, 2, 3, 40), (1, 1, 1, 1 << 20)])
def test_verify_split_rows_cover_the_table(B, W, h, capacity):
    """The verify kernel's chunk: a multiple of its 64-key tile, no
    smaller than the decode kernel's, at most 512 splits; the splits
    cover the table's
    capacity with none wholly past it; at the serving shapes it is the
    decode kernel's 64 rows, so a verify pass fills the card as a decode
    tick does."""
    C = pa.verify_split_rows(B, W, h, capacity)
    S = -(-capacity // C)
    n_grp = -(-W // 16)
    assert C % 64 == 0 and S <= 512
    assert C >= pa.decode_split_rows(B * n_grp, h, capacity)
    assert (S - 1) * C < capacity <= S * C or C == 64 and capacity < 64
    if (B, W, h, capacity) == (8, 5, 6, 1024):
        assert C == pa.decode_split_rows(B, h, capacity) == 64


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_cuda_verify_kernel_matches_plain(dtype, tol):
    """On the card: the verify kernel against the plain version at the
    serving path's shapes (8 slots, W = 5, 6 heads of 128, block 16,
    64-entry tables, one slot within W of the table's end); each element
    held to its own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    B, W, h, dh, bs, mb = 8, 5, 6, 128, 16, 64
    nb = 1 + B * mb
    kp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    vp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    q = torch.randn((B, W, h, dh), generator=g, device="cuda").to(dt)
    tbl = (torch.randperm(nb - 1, generator=g, device="cuda").reshape(
        B, mb) + 1).to(torch.int32)
    pos0 = torch.tensor([0, 15, 16, 17, 511, 1022, 700, 250],
                        dtype=torch.int32, device="cuda")
    l0 = pa.paged_verify_attention.launches
    out = pa.paged_verify_attention(q, kp, vp, tbl, pos0)
    ref = pa.paged_verify_attention_reference(q, kp, vp, tbl, pos0,
                                              1.0 / dh ** 0.5)
    torch.cuda.synchronize()
    assert pa.paged_verify_attention.launches == l0 + 1
    assert _scaled_err(out, ref) <= tol


def _verify_on_card(seed, dtype, B, W, positions, h=6, dh=128, bs=16,
                    mb=64, split_rows=None):
    """The verify kernel against the plain version on the card, over the
    valid rows only: slot b has a budget of 1..W written rows (W for a
    slot within W of the table's end), and the kernel's pools hold NaN in
    the scratch block 0 and in every row past a slot's last written one —
    rows a deeper (unwritten) query row may see, which must never reach a
    shallower row as 0 * NaN.  Returns (valid kernel rows, valid plain
    rows).  ``split_rows``: the wrapper's (the chunk's shape)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    L = mb * bs
    nb = 1 + B * mb
    kp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    vp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    q = torch.randn((B, W, h, dh), generator=g, device="cuda").to(dt)
    tbl = (torch.randperm(nb - 1, generator=g, device="cuda").reshape(
        B, mb) + 1).to(torch.int32)
    budget = [W if p + W > L else 1 + (7 * b + seed) % W
              for b, p in enumerate(positions)]
    k_bad, v_bad = kp.clone(), vp.clone()
    k_bad[0] = v_bad[0] = float("nan")
    for b, (p, n) in enumerate(zip(positions, budget)):
        for j in range(min(p + n, L), min(p + W + bs, L)):
            blk = int(tbl[b, j // bs])
            k_bad[blk, :, j % bs] = v_bad[blk, :, j % bs] = float("nan")
    pos0 = torch.tensor(positions, dtype=torch.int32, device="cuda")
    l0 = pa.paged_verify_attention.launches
    out = pa.paged_verify_attention(q, k_bad, v_bad, tbl, pos0,
                                    split_rows=split_rows)
    ref = pa.paged_verify_attention_reference(q, kp, vp, tbl, pos0,
                                              1.0 / dh ** 0.5)
    torch.cuda.synchronize()
    assert pa.paged_verify_attention.launches == l0 + 1
    valid = (torch.arange(W)[None, :] < torch.tensor(budget)[:, None]).to(
        out.device)
    return out[valid], ref[valid]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("W", [17, 20])
def test_cuda_verify_kernel_wide_chunks(W, dtype, tol):
    """On the card: W > 16 (two groups of rows) with one slot within W of
    the table's end, where the kernel raised before; each element held to
    its own size (bf16 at ``chip_smoke.py``'s K2 bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    out, ref = _verify_on_card(W, dtype, 8, W,
                               [0, 15, 16, 17, 511, 1024 - W + 3, 700, 250])
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("W", [1, 2, 5, 16])
def test_cuda_verify_kernel_split_edges(W, dtype, tol):
    """On the card: the split verify kernel with chunks that start, and
    contexts that end, on its split edges (C - 1, C, C + 1 and the
    table's last row, for the chunk C it takes at these shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    B, h, L = 8, 6, 1024
    C = pa.verify_split_rows(B, W, h, L, torch.cuda.get_device_properties(
        0).multi_processor_count)
    positions = [C - 1, C, C + 1, L - 1, C - W, C - W + 1, 2 * C - W,
                 L - W]
    out, ref = _verify_on_card(100 + W, dtype, B, W,
                               [max(p, 0) for p in positions])
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= tol


# -- head dims past the fast kernels: dh 12 (rows not 16-byte aligned in
# bf16), 160, 256 and 384 (zoo.Gpt(n_heads=2); bf16 past 128 takes the
# wide builds, below, f32 the any-dh kernel's register widths)
ANY_DH = [12, 160, 256, 384]


@pytest.mark.parametrize("dh", ANY_DH)
def test_any_head_dim_plain_matches_jax_reference_and_pallas_interpret(dh):
    """The decode read at head dims the fast CUDA kernel does not take:
    the plain version against the JAX reference and its Pallas kernel in
    interpret mode on the same numpy inputs (f32, 1e-6)."""
    jnp = _jnp()
    from deeplearning4j_tpu.kernels.paged_attention import (
        _paged_decode_pallas, paged_decode_attention_reference)
    q, kp, vp, tbl, pos, scale = _paged_fixture(dh, dh=dh)
    args = [jnp.asarray(a) for a in (q, kp, vp, tbl, pos)]
    ref = np.asarray(paged_decode_attention_reference(*args, scale))
    pallas = np.asarray(_paged_decode_pallas(*args, scale))
    out = pa.paged_decode_attention(*_torch(q, kp, vp, tbl, pos),
                                    scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dh", ANY_DH)
@pytest.mark.parametrize("W", [3, 17])
def test_any_head_dim_verify_plain_matches_jax_reference(dh, W):
    """The verify read at the same head dims, against the JAX reference
    and its Pallas kernel in interpret mode (f32, 1e-6)."""
    jnp = _jnp()
    from deeplearning4j_tpu.kernels.paged_attention import (
        _paged_verify_pallas, paged_verify_attention_reference)
    q, kp, vp, tbl, pos0, scale = _verify_fixture(dh + W, W, 4, dh=dh)
    args = [jnp.asarray(a) for a in (q, kp, vp, tbl, pos0)]
    ref = np.asarray(paged_verify_attention_reference(*args, scale))
    pallas = np.asarray(_paged_verify_pallas(*args, scale))
    out = pa.paged_verify_attention(*_torch(q, kp, vp, tbl, pos0),
                                    scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-6)


def test_head_dim_routes_and_limit():
    """Which kernel a head dim takes on the card: the fast one only at
    multiples of 8 up to 128; the wide builds in bf16 at every multiple
    of 8 in (128, 512]; the any-dh kernel at 12 and 100, in f32 past 128,
    in bf16 at 520 and at a block size the wide decode build refuses.
    No head dim is refused: 264, 640 and 1032 route with no error."""
    assert [pa._fast_dh(d) for d in (8, 64, 128, 12, 136, 160, 256)] == \
        [True, True, True, False, False, False, False]
    wide = (136, 160, 192, 200, 256, 384, 512)
    dims = (8, 64, 128, 12, 100) + wide + (520,)
    for verify in (False, True):
        assert [pa.kernel_route(d, torch.bfloat16, 16, 64, verify)
                for d in dims] == ["fast"] * 3 + ["any_dh"] * 2 + \
            ["wide"] * len(wide) + ["any_dh"]
        assert [pa.kernel_route(d, torch.float32, 16, 64, verify)
                for d in dims] == ["fast"] * 3 + ["any_dh"] * (len(dims) - 3)
    for d in wide:      # a block of 12 rows does not divide the chunk
        assert pa.kernel_route(d, torch.bfloat16, 12, 64) == "any_dh"
        assert pa.kernel_route(d, torch.bfloat16, 12, 64, True) == "wide"
    B, W, h, bs, mb = 2, 5, 2, 16, 4
    for d, want in ((264, "wide"), (640, "any_dh"), (1032, "any_dh")):
        for dt in (torch.bfloat16, torch.float32):
            pool = torch.empty((1 + B * mb, h, bs, d), dtype=dt)
            tbl = torch.ones((B, mb), dtype=torch.int32)
            for q, verify in ((torch.empty((B, h, d), dtype=dt), False),
                              (torch.empty((B, W, h, d), dtype=dt), True)):
                route, chunk = pa.call_route(q, pool, tbl, verify)
                assert route == (want if dt == torch.bfloat16
                                 else "any_dh"), (d, dt, verify)
                assert chunk > 0


@pytest.mark.parametrize("dh", [192, 256, 512])
def test_wide_decode_refuses_pages_off_the_split_edges(dh):
    """The wide decode build copies whole pages, so it takes a block size
    only where the split edges fall on page edges (bs divides the chunk)
    and a page pair of K and V fits its ring (2 bs dh bf16 values in
    196,608 bytes); every other block size takes the any-dh kernel.  The
    verify build copies rows: any block size."""
    takes = [(bs, C) for bs in (8, 12, 16, 24, 32, 48, 64, 96, 128)
             for C in (32, 64, 96, 128) if pa.wide_decode_takes(bs, C, dh)]
    fits = [(8, 32), (8, 64), (8, 96), (8, 128), (12, 96), (16, 32),
            (16, 64), (16, 96), (16, 128), (24, 96), (32, 32), (32, 64),
            (32, 96), (32, 128), (48, 96), (64, 64), (64, 128), (96, 96)]
    # past 96 rows a page pair at dh 512 (4 x 128 x 512 bytes) outgrows
    # the ring; at 192 and 256 a 128-row page still fits
    assert takes == fits + ([(128, 128)] if dh < 512 else [])
    for bs, C in ((12, 32), (24, 64), (48, 64), (96, 128)):
        assert pa.kernel_route(dh, torch.bfloat16, bs, C) == "any_dh"
        assert pa.kernel_route(dh, torch.bfloat16, bs, C, True) == "wide"
    assert (pa.kernel_route(dh, torch.bfloat16, 128, 128)
            == ("any_dh" if dh == 512 else "wide"))


@pytest.mark.parametrize("dh,h", [(256, 3), (192, 4)])
@pytest.mark.parametrize("bs", [8, 16])
def test_wide_decode_chunk_is_page_aligned_and_fills_the_card(dh, h, bs):
    """The decode chunk at the wide builds' serving shapes (8 slots, 3
    heads of 256 or 4 of 192, a 1024-row table): a whole number of pages
    at blocks 8 and 16 (the wide build takes it), splits that cover the
    table's pages once each, and >= 2 live (slot, head, split) blocks per
    SM of an H100 at ``chip_smoke.py``'s timing contexts; the verify
    chunk (one 64-key tile a block) >= 1 per SM."""
    B, cap, sms = 8, 1024, 132
    C = pa.decode_split_rows(B, h, cap, sms)
    assert C % bs == 0 and pa.kernel_route(dh, torch.bfloat16, bs, C) == \
        "wide"
    S = -(-cap // C)
    pages = [p for s in range(S) for p in range(s * C // bs,
                                                 min(cap, (s + 1) * C) // bs)]
    assert pages == list(range(cap // bs))
    ctx = [p + 1 for p in (444, 385, 377, 326, 427, 173, 709, 794)]
    assert h * sum(-(-n // C) for n in ctx) >= 2 * sms
    Cv = pa.verify_split_rows(B, 5, h, cap, sms)
    assert h * sum(-(-(n + 4) // Cv) for n in ctx) >= sms


# (dtype, head dim) of the card's any-head-dim cases: bf16 at 12 (rows
# not 16-byte aligned), through the wide builds' range (136 .. 512, the
# width classes' edges and middles) and past it (520, the any-dh
# kernel); f32 at 12, 160 and 384 (the any-dh kernel's register widths)
# and 1032 (past 1024: two column slabs)
CARD_DH = [("bfloat16", d) for d in (12, 136, 160, 200, 256, 384, 512,
                                     520)] + \
    [("float32", d) for d in (12, 160, 384, 1032)]
CARD_TOL = {"decode": {"float32": 1e-5, "bfloat16": 3e-2},
            "verify": {"float32": 1e-5, "bfloat16": 5e-2}}


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype,dh", CARD_DH)
def test_cuda_any_head_dim_decode_matches_plain(dtype, dh, bs):
    """On the card: the decode wrapper at every head dim of ``CARD_DH``
    (the wide build in bf16 where it takes the block size, the any-dh
    kernel elsewhere) at blocks 8 to 64 against the plain version at the
    serving path's positions, NaN in block 0, past each slot's position
    and in every block no table entry reaches, each element held to its
    own size."""
    _need_card()
    h = 3 if dh < 384 else 2
    out, ref = _decode_on_card(dh + bs, dtype, h, dh, bs, 1024 // bs,
                               [0, 15, 16, 17, 511, 1023, 700, 250])
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= CARD_TOL["decode"][dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype,dh", CARD_DH)
def test_cuda_any_head_dim_verify_matches_plain(dtype, dh, bs):
    """On the card: the verify wrapper at the same head dims and blocks
    with W = 5, NaN in block 0 and past every slot's written rows, valid
    rows held to the plain version."""
    _need_card()
    h = 3 if dh < 384 else 2
    out, ref = _verify_on_card(dh + bs, dtype, 8, 5,
                               [0, 15, 16, 17, 511, 1020, 700, 250],
                               h=h, dh=dh, bs=bs, mb=1024 // bs)
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= CARD_TOL["verify"][dtype]


# -- the wide builds (bf16 at the multiples of 8 in (128, 512]): K1
# copies pages, K2 rows; f32 at these head dims takes the any-dh kernel.
# (head dim, heads): Gpt(n_heads=4, 3, 2) at d 768, the width classes'
# edges (136, 512) and a dh off a multiple of 16 (200)
WIDE = [(192, 4), (256, 3), (136, 3), (160, 3), (200, 3), (384, 2),
        (512, 2)]


def _decode_on_card(seed, dtype, h, dh, bs, mb, positions,
                    split_rows=None):
    """The decode wrapper on the card against the plain version: NaN in
    the scratch block 0, in every row of a slot's last block past its
    position and in every block no table entry reaches (unused entries
    point at block 0).  ``split_rows``: the wrapper's.  Returns (kernel,
    plain)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    B = len(positions)
    need = [p // bs + 1 for p in positions]
    nb = 1 + sum(need) + 3
    kp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    vp = torch.randn((nb, h, bs, dh), generator=g, device="cuda").to(dt)
    q = torch.randn((B, h, dh), generator=g, device="cuda").to(dt)
    perm = (torch.randperm(nb - 1, generator=g, device="cuda") + 1).tolist()
    tbl = torch.zeros((B, mb), dtype=torch.int32)
    k_bad, v_bad = kp.clone(), vp.clone()
    k_bad[0] = v_bad[0] = float("nan")
    for b, n in enumerate(need):
        ids, perm = perm[:n], perm[n:]
        tbl[b, :n] = torch.tensor(ids, dtype=torch.int32)
        off = positions[b] % bs
        k_bad[ids[-1], :, off + 1:] = v_bad[ids[-1], :, off + 1:] = \
            float("nan")
    for blk in perm:
        k_bad[blk] = v_bad[blk] = float("nan")
    tbl = tbl.cuda()
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    l0 = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, k_bad, v_bad, tbl, pos,
                                    split_rows=split_rows)
    ref = pa.paged_decode_attention_reference(q, kp, vp, tbl, pos,
                                              1.0 / dh ** 0.5)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == l0 + 1
    return out, ref


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dh,h", WIDE)
def test_cuda_wide_decode_matches_plain(dh, h, bs, dtype, tol):
    """On the card: the decode wrapper at dh 192 and 256 (the wide build
    in bf16, the any-dh kernel in f32) on its split edges (C - 1, C,
    C + 1, 2C - 1 and the table's last row, for the chunk C it takes),
    a context ending mid-page, a slot filling one split beside slots
    filling all; NaN past every context never reaches an output."""
    _need_card()
    mb, L = 1024 // bs, 1024
    C = pa.decode_split_rows(8, h, L, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert pa.kernel_route(dh, getattr(torch, dtype), bs, C) == (
        "wide" if dtype == "bfloat16" else "any_dh")
    out, ref = _decode_on_card(dh + bs, dtype, h, dh, bs, mb,
                               [C - 1, C, C + 1, L - 1, 0, 2 * C - 1,
                                5 * bs + bs // 2, C // 2])
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dh,h", WIDE)
def test_cuda_wide_decode_refused_block_takes_any_dh(dh, h):
    """On the card: bf16 at a block of 12 rows, which does not divide the
    chunk, takes the any-dh kernel, held to the plain version."""
    _need_card()
    C = pa.decode_split_rows(8, h, 1020, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert pa.kernel_route(dh, torch.bfloat16, 12, C) == "any_dh"
    out, ref = _decode_on_card(7, "bfloat16", h, dh, 12, 85,
                               [0, 11, 12, 13, 500, 1019, 700, 250])
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("W", [1, 5, 17])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dh,h", WIDE)
def test_cuda_wide_verify_matches_plain(dh, h, bs, W, dtype, tol):
    """On the card: the verify wrapper at dh 192 and 256 (the wide build
    in bf16, the any-dh kernel in f32) with chunks starting and contexts
    ending on its split edges, mid-page and at the table's end; NaN in
    block 0 and past every slot's written rows (which deeper, unwritten
    query rows may see) never reaches a valid row as 0 * NaN."""
    _need_card()
    L = 1024
    C = pa.verify_split_rows(8, W, h, L, torch.cuda.get_device_properties(
        0).multi_processor_count)
    positions = [C - 1, C, C + 1, L - W, max(C - W, 0), 5 * bs + 3,
                 2 * C - W + 1, L - 1]
    out, ref = _verify_on_card(dh + W + bs, dtype, 8, W, positions, h=h,
                               dh=dh, bs=bs, mb=L // bs)
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [136, 192, 256, 384, 512])
def test_cuda_wide_long_context_merges(dh):
    """On the card, bf16: one head with contexts of up to 16,000 rows, so
    the wide decode build merges up to 500 splits (windows of 128 under a
    running max, summed by 3 groups of the block at dh 136, 2 at 192 and
    256, 1 past) and the wide verify build up to 250 (more splits than a
    row's 16 merge lanes), each held to the plain version with NaN past
    every context."""
    _need_card()
    L = 16384
    assert pa.decode_split_rows(2, 1, L) == 32
    assert pa.verify_split_rows(2, 5, 1, L) == 64
    out, ref = _decode_on_card(dh, "bfloat16", 1, dh, 16, L // 16,
                               [16000, 9000])
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= 3e-2
    out, ref = _verify_on_card(dh + 1, "bfloat16", 2, 5, [16000, 9000],
                               h=1, dh=dh, bs=16, mb=L // 16)
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("split_rows", [(88, 1), (132, 1)])
@pytest.mark.parametrize("dh,h", WIDE)
def test_cuda_wide_builds_with_deeper_rings(dh, h, split_rows):
    """On the card, bf16: the wide builds with the split-K chunk forced
    larger through ``split_rows`` (K1 128 and 224 rows, K2 128 and 256
    keys), so each split cycles its ring — K1's 3 stages over 8 to 14
    pages, K2's 2 over 2 to 4 key tiles (1 stage past 384) — on its own
    split edges, held to the plain version with NaN past every
    context."""
    _need_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    C = pa.decode_split_rows(*split_rows, 1024, sms)
    Cv = pa.verify_split_rows(split_rows[0], 5, split_rows[1], 1024, sms)
    assert C >= 128 and Cv >= 128
    out, ref = _decode_on_card(dh + C, "bfloat16", h, dh, 16, 64,
                               [C - 1, C, C + 1, 1023, 0, 2 * C - 1,
                                5 * 16 + 8, C // 2], split_rows=split_rows)
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= 3e-2
    out, ref = _verify_on_card(dh + Cv, "bfloat16", 8, 5,
                               [Cv - 1, Cv, Cv + 1, 1019, Cv - 5, 83,
                                2 * Cv - 4, 1023], h=h, dh=dh,
                               split_rows=split_rows)
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= 5e-2


def _paged_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs, read by
    ``torch.profiler`` (after an unprofiled call that builds them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if "paged_" in e.key]


@pytest.mark.gpu
@pytest.mark.parametrize("dh,h", WIDE)
def test_cuda_wide_builds_launch_the_wide_kernels(dh, h):
    """One bf16 call of K1 and of K2 (W 5) at each head dim of ``WIDE``
    under ``torch.profiler`` runs ``paged_decode_wide_kernel<kVec, DH>``
    (1 vector a lane up to 256, 2 past; DH the head dim at the multiples
    of 64, else 0: read at run time) / ``paged_verify_wide_kernel<DHP,
    exact>`` (dh's width class, rounded up to 64; exact where dh is it)
    and not the any-dh kernel, while f32 at the same shapes runs
    ``paged_any_dh_kernel``: the route is by dtype and head dim, as the
    card sees it, and ``<wrapper>.builds`` counts each launch under the
    build that ran."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(dh + h)
    B, W, bs, mb = 8, 5, 16, 64
    nb = 1 + B * mb
    kp = torch.randn((nb, h, bs, dh), generator=g, device="cuda")
    vp = torch.randn((nb, h, bs, dh), generator=g, device="cuda")
    q1 = torch.randn((B, h, dh), generator=g, device="cuda")
    q2 = torch.randn((B, W, h, dh), generator=g, device="cuda")
    tbl = (torch.randperm(nb - 1, generator=g, device="cuda").reshape(
        B, mb) + 1).to(torch.int32)
    pos = torch.tensor([0, 15, 16, 17, 511, 1000, 700, 250],
                       dtype=torch.int32, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        k, v = kp.to(dt), vp.to(dt)
        for w in (pa.paged_decode_attention, pa.paged_verify_attention):
            w.builds = {}
        dec = _paged_kernels(lambda: pa.paged_decode_attention(
            q1.to(dt), k, v, tbl, pos))
        ver = _paged_kernels(lambda: pa.paged_verify_attention(
            q2.to(dt), k, v, tbl, pos))
        build = "wide" if dt == torch.bfloat16 else "any_dh"
        # two calls each (one to build, one profiled), counted by build
        assert pa.paged_decode_attention.builds == {build: 2}
        assert pa.paged_verify_attention.builds == {build: 2}
        exact = dh % 64 == 0
        inst = {"decode": f"{1 if dh <= 256 else 2}, {dh if exact else 0}",
                "verify": f"{-(-dh // 64) * 64}, {str(exact).lower()}"}
        for kind, names in (("decode", dec), ("verify", ver)):
            if dt == torch.bfloat16:
                assert any(f"paged_{kind}_wide_kernel<{inst[kind]}>" in n
                           for n in names), names
                assert not any("paged_any_dh_kernel" in n
                               for n in names), names
            else:
                assert any("paged_any_dh_kernel" in n for n in names), names
                assert not any("wide_kernel" in n for n in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("verify", [False, True])
def test_cuda_wide_misaligned_operand_raises(verify):
    """bf16 at dh 256 with q off 16-byte alignment (a contiguous view two
    bytes into its storage): the wide build refuses the bulk copies'
    source and the wrapper raises — no other kernel takes the call."""
    _need_card()
    B, W, h, dh, bs, mb = 2, 5, 1, 256, 16, 4
    shape = (B, W, h, dh) if verify else (B, h, dh)
    n = int(np.prod(shape))
    q = torch.zeros(n + 1, dtype=torch.bfloat16,
                    device="cuda")[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16
    pool = torch.zeros((1 + B * mb, h, bs, dh), dtype=torch.bfloat16,
                       device="cuda")
    tbl = torch.arange(1, 1 + B * mb, dtype=torch.int32,
                       device="cuda").reshape(B, mb)
    pos = torch.tensor([3, 40], dtype=torch.int32, device="cuda")
    wrapper = (pa.paged_verify_attention if verify
               else pa.paged_decode_attention)
    launches = wrapper.launches
    with pytest.raises(RuntimeError, match="_wide"):
        wrapper(q, pool, pool, tbl, pos)
    assert wrapper.launches == launches
