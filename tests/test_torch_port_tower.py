"""Port parity of the head-tower conv chain (kernel #6's plain version
and wrapper) against the JAX package on the CPU: the Pallas chain in
interpret mode, and `retinanet._subnet`'s four conv + bias + ReLU
layers. The CUDA kernel's legs are in test_torch_port_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mydetection_tpu.models import retinanet as jretinanet  # noqa: E402
from mydetection_tpu.ops.pallas.tower_kernel import (  # noqa: E402
    conv3x3_chain_pallas_impl,
)
from mydetection_tpu_torch.kernels.tower import (  # noqa: E402
    conv3x3_chain,
    conv3x3_chain_plain,
    conv3x3_chain_reference,
    pack_weights,
    unpack_weights,
)

# the JAX kernel test's case (tests/test_retinanet.py): (B, H, W, C), L
B, H, W, C, L = 2, 9, 13, 64, 4


def _case(seed=0, shape=(B, H, W, C), layers=L):
    """x NHWC with a non-zero mean, HWIO weights 0.1·N(0, 1) (L, 3, 3,
    C, C), biases N(0, 1) (L, C), float32 numpy."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) + 0.5).astype(np.float32)
    ws = (0.1 * rng.randn(layers, 3, 3, c, c)).astype(np.float32)
    bs = rng.randn(layers, c).astype(np.float32)
    return x, ws, bs


def _port_args(x, ws, bs, dtype):
    """The same case in the port's layout: NCHW x, packed weights."""
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    oihw = torch.from_numpy(ws).permute(0, 4, 3, 1, 2)
    return tx, pack_weights(oihw, dtype), torch.from_numpy(bs)


def _max_scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("dtype,gate", [("float32", 2e-5), ("bfloat16", 0.05)])
def test_plain_chain_matches_pallas_interpret(dtype, gate):
    """The JAX test's gates for the Pallas kernel against the pure-jax
    loop, max-scaled: float32 2e-5 (the sums reassociate), bf16 0.05
    (the kernel rounds once per layer after the bias, XLA's conv before
    it, and the plain version follows XLA)."""
    x, ws, bs = _case()
    ref = conv3x3_chain_pallas_impl(jnp.asarray(x, getattr(jnp, dtype)),
                                    jnp.asarray(ws), jnp.asarray(bs),
                                    interpret=True)
    got = conv3x3_chain_plain(*_port_args(x, ws, bs, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().permute(0, 2, 3, 1).numpy()
    err = _max_scaled(got, np.asarray(ref.astype(jnp.float32)))
    assert err <= gate, err


@pytest.mark.parametrize("shape,layers", [((B, H, W, C), L),
                                          ((1, 5, 7, 64), 1)])
def test_reference_matches_pallas_interpret_bf16(shape, layers):
    """The kernel-order reference (float32 conv of the bf16 values, the
    float32 bias, the ReLU, one rounding a layer) against the Pallas
    chain in bf16: at most one bf16 ulp apart, element by element (the
    two sum in other orders: at four layers one element of 14,976 lands
    one ulp away, at one layer none)."""
    x, ws, bs = _case(4, shape, layers)
    ref = conv3x3_chain_pallas_impl(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(ws), jnp.asarray(bs),
                                    interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = conv3x3_chain_reference(*_port_args(x, ws, bs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    big = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30)))
                                    - 7), 0.0)
    assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


def test_reference_is_plain_in_float32():
    """In float32 the reference and the plain version do the same
    operations in the same order: bit for bit."""
    args = _port_args(*_case(5), torch.float32)
    assert torch.equal(conv3x3_chain_reference(*args),
                       conv3x3_chain_plain(*args))


def test_plain_chain_matches_subnet_layers():
    """`retinanet._subnet` with an identity output conv (centre tap the
    identity, zero bias) is exactly its four conv + bias + ReLU layers;
    the plain chain matches it within 1e-6 max-scaled in float32."""
    x, ws, bs = _case(1)
    p = {f"conv{i}": {"w": jnp.asarray(ws[i]), "b": jnp.asarray(bs[i])}
         for i in range(L)}
    ident = np.zeros((3, 3, C, C), np.float32)
    ident[1, 1] = np.eye(C, dtype=np.float32)
    p["out"] = {"w": jnp.asarray(ident), "b": jnp.zeros((C,), jnp.float32)}
    ref = jretinanet._subnet(p, jnp.asarray(x), compute_dtype=jnp.float32)
    got = conv3x3_chain_plain(*_port_args(x, ws, bs, torch.float32))
    err = _max_scaled(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert err <= 1e-6, err


def test_wrapper_takes_plain_version_on_cpu():
    args = _port_args(*_case(2), torch.float32)
    before = conv3x3_chain.launches
    got = conv3x3_chain(*args)
    assert conv3x3_chain.launches == before  # nothing launched
    assert torch.equal(got, conv3x3_chain_plain(*args))


def test_packed_layout_is_the_tpu_kernels():
    """pack_weights of the OIHW weights is the TPU kernel's (L·9·C, C)
    HWIO reshape split by layer: row (t·C + c_in) of layer l is tap t's
    weights from input channel c_in; unpack_weights inverts it."""
    _, ws, _ = _case(3)
    oihw = torch.from_numpy(ws).permute(0, 4, 3, 1, 2)
    packed = pack_weights(oihw, torch.float32)
    np.testing.assert_array_equal(packed.numpy(),
                                  ws.reshape(L, 9 * C, C))
    assert torch.equal(unpack_weights(packed), oihw)
    assert packed.is_contiguous()
    assert pack_weights(list(oihw), torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="3x3"):
        pack_weights(oihw[:, :, :, :1], torch.float32)


def test_wrapper_rejects_other_devices():
    x = torch.zeros(1, 16, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv3x3_chain(x, torch.zeros(1, 144, 16, device="meta"),
                      torch.zeros(1, 16, device="meta"))
