"""The port's ring attention (sequence parallelism), held to
``tests/test_ring_attention.py``: exact equality with full attention on
an 8-way ring, a padding mask whose keys cannot leak, gradients through
the rotation, a data x sequence mesh and the missing-axis error; and the
port's ``full_attention_reference`` against the JAX one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.parallel.mesh import Mesh, MeshConfig  # noqa
from deeplearning4j_torch.parallel.ring_attention import (  # noqa: E402
    full_attention_reference, ring_self_attention)

CPU8 = [torch.device("cpu")] * 8


def _qkv(b=2, h=2, t=32, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(b, h, t, d)),
                                 dtype=torch.float32) for _ in range(3))


def test_ring_matches_full_attention_8way():
    mesh = MeshConfig(sequence=8).build(CPU8)
    q, k, v = _qkv()
    out = ring_self_attention(mesh, q, k, v)
    ref = full_attention_reference(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def test_ring_with_padding_mask():
    mesh = MeshConfig(sequence=4).build(CPU8[:4])
    q, k, v = _qkv(t=16)
    mask = np.ones((2, 16), np.float32)
    mask[:, 12:] = 0
    mask = torch.as_tensor(mask)
    out = ring_self_attention(mesh, q, k, v, mask)
    ref = full_attention_reference(q, k, v, mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)
    # masked keys truly cannot influence the output
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 12:] = 999.0
    v2[:, :, 12:] = -999.0
    out2 = ring_self_attention(mesh, q, k2, v2, mask)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=2e-5)


def test_ring_gradients_match_full():
    mesh = MeshConfig(sequence=4).build(CPU8[:4])

    def grads(fn):
        qkv = [t.requires_grad_(True) for t in _qkv(t=16)]
        loss = torch.sum(torch.square(fn(*qkv)))
        return torch.autograd.grad(loss, qkv)

    g_ring = grads(lambda q, k, v: ring_self_attention(mesh, q, k, v))
    g_full = grads(full_attention_reference)
    for gr, gf in zip(g_ring, g_full):
        np.testing.assert_allclose(gr.numpy(), gf.numpy(), atol=5e-4)


def test_ring_on_data_x_sequence_mesh():
    """dp x sp: batch split over 'data', sequence over 'sequence'."""
    mesh = MeshConfig(data=2, sequence=4).build(CPU8)
    q, k, v = _qkv(b=4, t=16)
    out = ring_self_attention(mesh, q, k, v)
    ref = full_attention_reference(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def test_ring_requires_sequence_axis():
    mesh = Mesh(CPU8[:4], ("data",))
    q, k, v = _qkv(t=16)
    with pytest.raises(ValueError, match="sequence"):
        ring_self_attention(mesh, q, k, v)


def test_full_attention_reference_matches_jax():
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.ring_attention import (
        full_attention_reference as jfull)
    q, k, v = _qkv(t=16, seed=3)
    mask = np.ones((2, 16), np.float32)
    mask[1, 9:] = 0
    for m in (None, mask):
        got = full_attention_reference(
            q, k, v, None if m is None else torch.as_tensor(m))
        want = jfull(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                     None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)
