"""The fused bias + GroupNorm + ReLU of the port against the JAX package.

`bias_gn_relu_plain` (the CUDA kernel's plain version, which the CPU
runs) against the TPU kernel `bias_gn_relu_pallas_impl` in interpret
mode, and against the unfused oracle `fcos.group_norm` + bias + ReLU.
Same numpy inputs (seeded) through both, NHWC on the JAX side and NCHW
on the port's; and the CUDA kernels' launch plan (`gn_plan`), a pure
function of the shape. The CUDA kernel's legs are in
test_torch_port_cuda.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mydetection_tpu.models import fcos as jfcos  # noqa: E402
from mydetection_tpu.ops.pallas.gn_kernel import (  # noqa: E402
    bias_gn_relu_pallas_impl,
)
from mydetection_tpu_torch.kernels import gn as tgn  # noqa: E402
from mydetection_tpu_torch.kernels.gn import (  # noqa: E402
    bias_gn_relu,
    bias_gn_relu_plain,
)
from mydetection_tpu_torch.models import fcos as tfcos  # noqa: E402

SHAPES = [(2, 8, 8, 256), (3, 5, 7, 64)]
MEANS = [0.0, 1.0, 3.0]


def _gate(base, mean):
    """`base` at zero mean, widened by 1 + mean²/var (var = 1 here): the
    one-pass variance E[x²] − E[x]² subtracts two sums of that size, so
    float32 rounding in the sums (of another order in each version)
    grows with it. Measured max |Δ| against the Pallas kernel: 1.2e-6 at
    mean 0, 1.4e-6 at mean 1, 9.3e-6 at mean 3."""
    return base * (1.0 + mean * mean)


def _inputs(shape, mean, seed=0):
    """x (B, H, W, C) with the given mean and unit spread, bias N(0, 0.5),
    scale 1 + N(0, 0.2), shift N(0, 0.5), all float32."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) + mean).astype(np.float32)
    return (x, (rng.randn(c) * 0.5).astype(np.float32),
            (1 + rng.randn(c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.5).astype(np.float32))


def _port(x, bias, scale, shift, dtype=torch.float32, **kw):
    """The plain version on NHWC numpy input; returns NHWC float32."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    y = bias_gn_relu_plain(xt, torch.from_numpy(bias), torch.from_numpy(scale),
                           torch.from_numpy(shift), **kw)
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mean", MEANS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, mean):
    """The same arithmetic (f32 bias add, E[x²] − E[x]², ((x − mean)·inv)
    ·scale + shift) summed in another order: max |Δ| ≤ 2e-6 at zero
    mean, the JAX package's own figure for its kernel against the
    oracle, widened with the mean by `_gate`."""
    x, bias, scale, shift = _inputs(shape, mean)
    ref = np.asarray(bias_gn_relu_pallas_impl(
        jnp.asarray(x), jnp.asarray(bias), jnp.asarray(scale),
        jnp.asarray(shift), groups=32, interpret=True))
    got = _port(x, bias, scale, shift, groups=32)
    assert np.abs(got - ref).max() <= _gate(2e-6, mean)
    assert (got == 0).any() and (got > 0).any()  # the ReLU cut some


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_within_one_ulp_of_pallas_interpret(shape):
    """bf16 in and out, f32 inside: the two f32 results are a few ulps
    apart, so their bf16 roundings differ by at most one bf16 ulp."""
    x, bias, scale, shift = _inputs(shape, 1.0, seed=1)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(bias_gn_relu_pallas_impl(
        jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(bias),
        jnp.asarray(scale), jnp.asarray(shift), groups=32,
        interpret=True).astype(jnp.float32))
    got = _port(xb, bias, scale, shift, dtype=torch.bfloat16, groups=32)
    big = np.maximum(np.abs(got), np.abs(ref))
    ulp = (big.view(np.int32) & 0x7F800000).view(np.float32) * 2.0 ** -7
    assert (np.abs(got - ref) <= ulp + 1e-6).all()


@pytest.mark.parametrize("mean", MEANS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_unfused_group_norm(shape, mean):
    """Against the JAX package's unfused path (`fcos.group_norm` after
    the bias, then ReLU), which takes the variance in two passes as
    E[(x − E[x])²]. The one-pass E[x²] − E[x]² loses the bits the
    cancellation costs (about log2(1 + mean²/var) of them) where the
    two-pass form loses none, so the gate is twice the like-for-like
    kernel gate (measured: 5.7e-6 at mean 3, against 4e-5)."""
    x, bias, scale, shift = _inputs(shape, mean)
    ref = np.asarray(jnp.maximum(jfcos.group_norm(
        jnp.asarray(x) + jnp.asarray(bias),
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}), 0.0))
    got = _port(x, bias, scale, shift, groups=32)
    assert np.abs(got - ref).max() <= _gate(4e-6, mean)


@pytest.mark.parametrize("shape", SHAPES)
def test_port_group_norm_oracle_matches_jax(shape):
    """The port's copy of the unfused oracle, `models/fcos.group_norm`:
    the mean's own rounding grows with the mean too (measured 4.3e-6 at
    mean 3)."""
    x, _, scale, shift = _inputs(shape, 3.0, seed=2)
    ref = np.asarray(jfcos.group_norm(
        jnp.asarray(x), {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(shift)}))
    got = tfcos.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(scale), torch.from_numpy(shift))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() <= _gate(2e-6, 3.0)


def test_layouts_give_the_same_output():
    """channels_last (the card's conv output) and contiguous NCHW input."""
    x, bias, scale, shift = (torch.from_numpy(a) for a in
                             _inputs((2, 6, 5, 64), 1.0, seed=3))
    nchw = x.permute(0, 3, 1, 2).contiguous()
    cl = nchw.contiguous(memory_format=torch.channels_last)
    assert not cl.is_contiguous()
    a = bias_gn_relu_plain(nchw, bias, scale, shift, groups=32)
    b = bias_gn_relu_plain(cl, bias, scale, shift, groups=32)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch; a
    tensor elsewhere than the CPU or a CUDA card is refused."""
    x, bias, scale, shift = (torch.from_numpy(a) for a in
                             _inputs((2, 4, 4, 64), 1.0, seed=4))
    x = x.permute(0, 3, 1, 2)
    before = bias_gn_relu.launches
    np.testing.assert_array_equal(
        bias_gn_relu(x, bias, scale, shift, groups=32).numpy(),
        bias_gn_relu_plain(x, bias, scale, shift, groups=32).numpy())
    assert bias_gn_relu.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bias_gn_relu(x.to("meta"), bias, scale, shift)


# ---------------------------------------------------------------------------
# the CUDA kernels' launch plan (kernels/gn.py::gn_plan), a pure function
# ---------------------------------------------------------------------------

def _levels(size):
    return [(math.ceil(size / s),) * 2 for s in (8, 16, 32, 64, 128)]


PLAN_CASES = [(size, lv, b, elem)
              for size in (608, 1024) for lv in range(5) for b in (1, 16, 32)
              for elem in (2, 4)]


def _check_plan(kind, b, hw, c, elem, groups=32):
    """What csrc/gn.cu's launcher assumes of a plan, and that its
    blocks' ranges cover every pixel of every image exactly once."""
    plan = tgn.gn_plan(kind, b, hw, c, groups, elem)
    row = c * elem
    assert 1 <= plan.cluster <= tgn.MAX_CLUSTER and plan.cluster <= hw
    assert plan.blocks == b * plan.cluster
    most = -(-hw // plan.cluster)
    if plan.resident:
        assert plan.tile >= most
        if kind == "fwd":
            assert plan.stages == 0
            assert plan.slots >= -(-most // plan.chunk)
        else:
            assert plan.stages >= 2 and plan.chunk2 <= 3 * plan.chunk
    else:
        assert plan.stages >= 2
        assert plan.chunk2 == plan.chunk and plan.slots >= plan.stages
    smem = tgn._smem_bytes(kind, c, elem, groups, resident=plan.resident,
                           tile=plan.tile, stages=plan.stages,
                           chunk=plan.chunk, slots=plan.slots)
    # the block's tile (or ring) plus everything else fits 227 KB
    assert plan.smem == smem <= tgn.SMEM_LIMIT
    assert (plan.tile if plan.resident else plan.stages * plan.chunk) * row \
        < plan.smem
    seen = np.zeros((b, hw), np.int64)
    for img, lo, n in tgn.gn_ranges(plan, hw):
        assert n >= 1 and n <= most
        seen[img, lo:lo + n] += 1
    assert (seen == 1).all()
    return plan


@pytest.mark.parametrize("size,level,b,elem", PLAN_CASES)
def test_gn_plan_fits_and_covers(size, level, b, elem):
    """Every FCOS level at 608 and 1024, batch 1, 16 and 32, bf16 and
    f32: both kernels' plans fit shared memory, take clusters of at most
    16 that divide the grid, and cover every pixel exactly once; bf16 at
    608 holds each block's range on chip (the forward and the
    backward's dpre), and f32 P3 at 608 (5.9 MB an image) streams."""
    h, w = _levels(size)[level]
    fwd = _check_plan("fwd", b, h * w, 256, elem)
    bwd = _check_plan("bwd", b, h * w, 256, elem)
    if size == 608 and elem == 2:
        assert fwd.resident and bwd.resident
    if size == 608 and level == 0 and elem == 4:
        assert not fwd.resident and not bwd.resident


@pytest.mark.parametrize("size,level,b", [(size, lv, b)
                                          for size, bs in ((608, (1, 32)),
                                                           (128, (2,)))
                                          for lv in range(5) for b in bs])
def test_gn_plan_takes_the_int8_towers(size, level, b):
    """The int8 fcos towers (`quant_resnet`) launch the forward kernel
    on float32 (4-byte) activations at every level: at 608, batch 1 and
    32 (the detect paths), and at 128, batch 2 (the card-vs-CPU int8
    test); each plan fits and covers, and f32 P3 at 608 streams."""
    h, w = _levels(size)[level]
    plan = _check_plan("fwd", b, h * w, 256, 4)
    assert plan.resident == (size != 608 or level != 0)


@pytest.mark.parametrize("b,h,w,c,elem", [(3, 5, 7, 256, 2), (3, 5, 7, 256, 4),
                                          (3, 5, 7, 64, 2), (3, 5, 7, 64, 4),
                                          (1, 128, 128, 256, 2),
                                          (1, 19, 19, 256, 2)])
def test_gn_plan_edge_shapes(b, h, w, c, elem):
    """The ragged 5x7, C = 64 (2 channels a group at 32 groups), P3 at
    1024 in bf16 (8.4 MB an image, which no cluster of 16 holds: both
    kernels stream it) and a 19x19 image its cluster does not split
    evenly."""
    fwd = _check_plan("fwd", b, h * w, c, elem)
    bwd = _check_plan("bwd", b, h * w, c, elem)
    if h == 128:
        assert not fwd.resident and not bwd.resident
        assert fwd.cluster == bwd.cluster == tgn.MAX_CLUSTER
    if (b, h) == (1, 19):
        assert fwd.cluster > 1 and (h * w) % fwd.cluster


@pytest.mark.parametrize("c,elem", [(4096, 2), (7, 4), (12, 2)])
def test_gn_plan_refuses_rows_the_kernels_do_not_take(c, elem):
    """A pixel row must be 16 to 4096 bytes in 16-byte steps."""
    with pytest.raises(ValueError, match="pixel row"):
        tgn.gn_plan("fwd", 2, 16, c, 1, elem)
