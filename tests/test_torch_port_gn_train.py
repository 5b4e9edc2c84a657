"""The trainable GroupNorm of the port against the JAX package.

The plain versions of the forward-with-statistics and of the fused
backward (the CPU path of `kernels/gn.py::bias_gn_relu_fwd_stats` and
`bias_gn_relu_bwd`) against the TPU kernels `_fwd_with_stats` and
`_bwd_fused` in interpret mode on the same residuals; the autograd
Function `BiasGNReLU` against `bias_gn_relu_trainable` and against
autograd through the unfused oracle `fcos.group_norm`. Seeded numpy
inputs go through both, NHWC on the JAX side and NCHW on the port's.
The CUDA kernels' legs are in test_torch_port_cuda.py.

Gates are max-scaled (error over the reference's max |value|), never
relative per element: gradients pass through 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mydetection_tpu.ops.pallas.gn_kernel import (  # noqa: E402
    _bwd_fused,
    _fwd_with_stats,
    bias_gn_relu_trainable,
)
from mydetection_tpu_torch.kernels import gn as tgn  # noqa: E402
from mydetection_tpu_torch.models import fcos as tfcos  # noqa: E402

SHAPES = [(2, 8, 8, 256), (3, 5, 7, 64)]
F32_GATE = 1e-5


def _max_scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


def _within_one_bf16_ulp(got, ref, floor=1e-6):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    big = np.maximum(np.abs(got), np.abs(ref))
    ulp = (big.view(np.int32) & 0x7F800000).view(np.float32) * 2.0 ** -7
    return bool((np.abs(got - ref) <= ulp + floor).all())


def _inputs(shape, seed, mean=1.0):
    """x (B, H, W, C) with the given mean and unit spread, dy N(0, 1),
    bias N(0, 0.5), scale 1 + N(0, 0.2), shift N(0, 0.5), float32."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return ((rng.randn(*shape) + mean).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            (rng.randn(c) * 0.5).astype(np.float32),
            (1 + rng.randn(c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.5).astype(np.float32))


def _t(a, dtype=torch.float32):
    """NHWC numpy → NCHW torch in `dtype`."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).to(dtype)


def _np(t):
    """NCHW torch → NHWC float32 numpy."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _bf16_round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_fwd(x, bias, scale, shift, dtype):
    y, mean, inv = _fwd_with_stats(
        jnp.asarray(x).astype(dtype), jnp.asarray(bias), jnp.asarray(scale),
        jnp.asarray(shift), groups=32, eps=1e-5, relu=True, interpret=True)
    return (np.asarray(y.astype(jnp.float32)), np.asarray(mean)[:, 0],
            np.asarray(inv)[:, 0])


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_stats_plain_matches_pallas_interpret(shape):
    """y, mean and inv in float32, max-scaled within 1e-5."""
    x, _, bias, scale, shift = _inputs(shape, 0)
    ref_y, ref_mean, ref_inv = _jax_fwd(x, bias, scale, shift, jnp.float32)
    y, mean, inv = tgn.bias_gn_relu_fwd_stats_plain(
        _t(x), *map(torch.from_numpy, (bias, scale, shift)), groups=32)
    assert mean.shape == inv.shape == (shape[0], 32)
    assert _max_scaled(_np(y), ref_y) <= F32_GATE
    assert _max_scaled(mean, ref_mean) <= F32_GATE
    assert _max_scaled(inv, ref_inv) <= F32_GATE
    assert (ref_y == 0).any() and (ref_y > 0).any()  # the ReLU cut some


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_stats_plain_bf16_matches_pallas_interpret(shape):
    """bf16 in and out, float32 statistics: y within one bf16 ulp, mean
    and inv max-scaled within 1e-5."""
    x, _, bias, scale, shift = _inputs(shape, 1)
    xb = _bf16_round(x)
    ref_y, ref_mean, ref_inv = _jax_fwd(xb, bias, scale, shift, jnp.bfloat16)
    y, mean, inv = tgn.bias_gn_relu_fwd_stats_plain(
        _t(xb, torch.bfloat16), *map(torch.from_numpy, (bias, scale, shift)),
        groups=32)
    assert y.dtype == torch.bfloat16
    assert _within_one_bf16_ulp(_np(y), ref_y)
    assert _max_scaled(mean, ref_mean) <= F32_GATE
    assert _max_scaled(inv, ref_inv) <= F32_GATE


def _jax_bwd(x, y, dy, bias, scale, mean, inv, dtype):
    dx, dbias, dscale, dshift = _bwd_fused(
        jnp.asarray(x).astype(dtype), jnp.asarray(y).astype(dtype),
        jnp.asarray(dy).astype(dtype), jnp.asarray(bias), jnp.asarray(scale),
        jnp.asarray(mean)[:, None, :], jnp.asarray(inv)[:, None, :],
        groups=32, relu=True, interpret=True)
    return [np.asarray(dx.astype(jnp.float32))] + [
        np.asarray(v) for v in (dbias, dscale, dshift)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_pallas_interpret(shape):
    """On the same residuals (the JAX forward's y, mean and inv), all
    four outputs in float32 max-scaled within 1e-5."""
    x, dy, bias, scale, shift = _inputs(shape, 2)
    y, mean, inv = _jax_fwd(x, bias, scale, shift, jnp.float32)
    ref = _jax_bwd(x, y, dy, bias, scale, mean, inv, jnp.float32)
    got = tgn.bias_gn_relu_bwd_plain(
        _t(x), _t(y), _t(dy), torch.from_numpy(bias), torch.from_numpy(scale),
        torch.from_numpy(mean), torch.from_numpy(inv), groups=32)
    assert got[0].dtype == torch.float32
    for name, g, r in zip(("dx", "dbias", "dscale", "dshift"),
                          [_np(got[0])] + [v.numpy() for v in got[1:]], ref):
        assert _max_scaled(g, r) <= F32_GATE, name


def test_bwd_plain_bf16_matches_pallas_interpret():
    """bf16 x, y and dy: dx within one bf16 ulp (plus 1e-6 where it
    rounds near 0), the float32 parameter gradients max-scaled within
    1e-5."""
    x, dy, bias, scale, shift = _inputs((3, 5, 7, 64), 3)
    xb, dyb = _bf16_round(x), _bf16_round(dy)
    y, mean, inv = _jax_fwd(xb, bias, scale, shift, jnp.bfloat16)
    ref = _jax_bwd(xb, y, dyb, bias, scale, mean, inv, jnp.bfloat16)
    got = tgn.bias_gn_relu_bwd_plain(
        _t(xb, torch.bfloat16), _t(y, torch.bfloat16), _t(dyb, torch.bfloat16),
        torch.from_numpy(bias), torch.from_numpy(scale),
        torch.from_numpy(mean), torch.from_numpy(inv), groups=32)
    assert got[0].dtype == torch.bfloat16
    assert _within_one_bf16_ulp(_np(got[0]), ref[0])
    for name, g, r in zip(("dbias", "dscale", "dshift"), got[1:], ref[1:]):
        assert _max_scaled(g.numpy(), r) <= F32_GATE, name


def test_bwd_plain_masks_by_the_saved_output():
    """The ReLU mask is the saved y's `y > 0`: where y is 0 the gradient
    of dy never enters, whatever the recomputed pre-activation."""
    x, dy, bias, scale, shift = _inputs((2, 4, 4, 64), 4)
    args = [_t(x), None, _t(dy), *map(torch.from_numpy, (bias, scale))]
    y, mean, inv = tgn.bias_gn_relu_fwd_stats_plain(
        args[0], *map(torch.from_numpy, (bias, scale, shift)), groups=32)
    masked = tgn.bias_gn_relu_bwd_plain(args[0], torch.zeros_like(y), args[2],
                                        *args[3:], mean, inv, groups=32)
    for t in masked:
        assert not t.any()
    live = tgn.bias_gn_relu_bwd_plain(args[0], y, args[2], *args[3:], mean,
                                      inv, groups=32)
    assert live[0].abs().max() > 0


# the test_fcos.py cases of the trainable GN: f32 (2, 7, 9, 64) with x
# of spread 2, bf16 (2, 5, 6, 64); gates 1e-5 (f32) and 2e-2 (bf16)
def _trainable_case(seed, shape):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    scale_x = 2.0 if seed == 1 else 1.0
    x = (rng.randn(*shape) * scale_x).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    scale = rng.uniform(0.5, 2, c).astype(np.float32)
    shift = rng.randn(c).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    return x, bias, scale, shift, ct


def _port_grads(x, bias, scale, shift, ct, dtype, fused):
    """sum(y·ct) (or sum(y²) in bf16) and its gradients through the
    port: `BiasGNReLU` when fused, else autograd through the oracle
    relu(group_norm(x + bias))."""
    xt = _t(x, dtype).requires_grad_(True)
    params = [torch.from_numpy(v).requires_grad_(True)
              for v in (bias, scale, shift)]
    if fused:
        y = tgn.BiasGNReLU.apply(xt, *params, 32)
    else:
        y = torch.relu(tfcos.group_norm(xt + params[0].to(dtype)[:, None, None],
                                        params[1], params[2], groups=32))
    loss = (y.float() * _t(ct)).sum() if ct is not None else (y.float() ** 2).sum()
    loss.backward()
    return float(loss.detach()), [_np(xt.grad)] + [p.grad.numpy() for p in params]


def _jax_grads(x, bias, scale, shift, ct, dtype):
    def loss(x, bias, scale, shift):
        y = bias_gn_relu_trainable(x, bias, scale, shift, groups=32,
                                   interpret=True).astype(jnp.float32)
        return jnp.sum(y * ct) if ct is not None else jnp.sum(y ** 2)

    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x).astype(dtype), *map(jnp.asarray, (bias, scale, shift)))
    return float(v), [np.asarray(t.astype(jnp.float32)) for t in g]


def test_trainable_f32_matches_jax_and_the_oracle():
    """Value rtol 1e-5; dx, dbias, dscale, dshift max-scaled within 1e-5
    of both the JAX custom_vjp and autograd through the unfused oracle
    (two-pass variance)."""
    case = _trainable_case(1, (2, 7, 9, 64))
    v, got = _port_grads(*case, torch.float32, fused=True)
    jv, ref = _jax_grads(*case, jnp.float32)
    ov, oracle = _port_grads(*case, torch.float32, fused=False)
    assert v == pytest.approx(jv, rel=1e-5)
    assert v == pytest.approx(ov, rel=1e-5)
    for name, g, r, o in zip(("dx", "dbias", "dscale", "dshift"), got, ref,
                             oracle):
        assert _max_scaled(g, r) <= F32_GATE, name
        assert _max_scaled(g, o) <= F32_GATE, name


def test_trainable_bf16_grads_close():
    """bf16 x in and y out: dbias, dscale and dshift within 2e-2
    max-scaled of the JAX custom_vjp and of the oracle, dx within the
    same of the JAX custom_vjp."""
    x, bias, scale, shift, _ = _trainable_case(2, (2, 5, 6, 64))
    x = _bf16_round(x)
    _, got = _port_grads(x, bias, scale, shift, None, torch.bfloat16,
                         fused=True)
    _, ref = _jax_grads(x, bias, scale, shift, None, jnp.bfloat16)
    _, oracle = _port_grads(x, bias, scale, shift, None, torch.bfloat16,
                            fused=False)
    assert _max_scaled(got[0], ref[0]) <= 2e-2
    for name, g, r, o in zip(("dbias", "dscale", "dshift"), got[1:], ref[1:],
                             oracle[1:]):
        assert _max_scaled(g, r) <= 2e-2, name
        assert _max_scaled(g, o) <= 2e-2, name


def test_tower_routes_by_grad_mode():
    """With grad the tower runs `BiasGNReLU` (the CPU plain versions of
    the forward-with-statistics and the backward); without, the
    inference wrapper (#3's plain version). Same values either way, and
    no launch counted on the CPU."""
    torch.manual_seed(0)
    tower = tfcos.Tower(64)
    for m in tower.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.normal_(m.weight, std=0.05)
            torch.nn.init.normal_(m.bias, std=0.1)
    x = torch.randn(2, 64, 6, 5)
    counts = [k.launches for k in (tgn.bias_gn_relu, tgn.bias_gn_relu_fwd_stats,
                                   tgn.bias_gn_relu_bwd)]
    with torch.no_grad():
        y0 = tower(x)
    assert y0.grad_fn is None
    y1 = tower(x)
    assert type(y1.grad_fn).__name__ == "BiasGNReLUBackward"
    torch.testing.assert_close(y1.detach(), y0, rtol=0, atol=0)
    y1.sum().backward()
    assert all(p.grad is not None for p in tower.parameters())
    assert counts == [k.launches for k in (
        tgn.bias_gn_relu, tgn.bias_gn_relu_fwd_stats, tgn.bias_gn_relu_bwd)]


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors the forward-with-statistics and backward wrappers
    return their plain versions' bits; other devices are refused."""
    x, dy, bias, scale, shift = (_inputs((2, 4, 4, 64), 5))
    xt, dyt = _t(x), _t(dy)
    b, s, t = map(torch.from_numpy, (bias, scale, shift))
    fwd = tgn.bias_gn_relu_fwd_stats(xt, b, s, t, groups=32)
    for a, r in zip(fwd, tgn.bias_gn_relu_fwd_stats_plain(xt, b, s, t,
                                                          groups=32)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    bwd = tgn.bias_gn_relu_bwd(xt, fwd[0], dyt, b, s, fwd[1], fwd[2],
                               groups=32)
    for a, r in zip(bwd, tgn.bias_gn_relu_bwd_plain(xt, fwd[0], dyt, b, s,
                                                    fwd[1], fwd[2], groups=32)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgn.bias_gn_relu_fwd_stats(xt.to("meta"), b, s, t)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgn.bias_gn_relu_bwd(xt.to("meta"), xt, dyt, b, s, fwd[1], fwd[2])
