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
                    mb=64):
    """The verify kernel against the plain version on the card, over the
    valid rows only: slot b has a budget of 1..W written rows (W for a
    slot within W of the table's end), and the kernel's pools hold NaN in
    the scratch block 0 and in every row past a slot's last written one —
    rows a deeper (unwritten) query row may see, which must never reach a
    shallower row as 0 * NaN.  Returns (valid kernel rows, valid plain
    rows)."""
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
    out = pa.paged_verify_attention(q, k_bad, v_bad, tbl, pos0)
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
# bf16), 160 and 256 (a 256-wide register row in the any-dh kernel)
ANY_DH = [12, 160, 256]


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
    """Which kernel a head dim takes on the card (the fast one only at
    multiples of 8 up to 128), and the one limit left: above 256."""
    assert [pa._fast_dh(d) for d in (8, 64, 128, 12, 136, 160, 256)] == \
        [True, True, True, False, False, False, False]
    with pytest.raises(ValueError, match="up to 256"):
        pa._check_dh("paged decode kernel", 264)
    pa._check_dh("paged decode kernel", 256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("dh", ANY_DH)
def test_cuda_any_head_dim_decode_matches_plain(dh, dtype, tol):
    """On the card: the decode wrapper at dh 12, 160 and 256 (the any-dh
    kernel) against the plain version at the serving path's slots and
    positions, each element held to its own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    g = torch.Generator(device="cuda").manual_seed(dh)
    dt = getattr(torch, dtype)
    B, h, bs, mb = 8, 3, 16, 64
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
    assert _scaled_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("dh", ANY_DH)
def test_cuda_any_head_dim_verify_matches_plain(dh, dtype, tol):
    """On the card: the verify wrapper at dh 12, 160 and 256 with W = 5,
    NaN in block 0 and past every slot's written rows, valid rows held
    to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")
    out, ref = _verify_on_card(dh, dtype, 8, 5,
                               [0, 15, 16, 17, 511, 1020, 700, 250],
                               h=3, dh=dh)
    assert bool(torch.isfinite(out).all())
    assert _scaled_err(out, ref) <= tol
