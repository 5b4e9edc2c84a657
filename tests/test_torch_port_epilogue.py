"""The conv epilogue (`kernels/epilogue.py`): its route, plain version and
fake implementation on the CPU, and the CUDA kernel on the card.

CPU: the route (`kernels.route.takes_kernel`, which
`layers.epilogue_kernel` reads at each call) holds only for an eval call
with no gradient needed outside `plain_versions()` on a CUDA tensor
(fake CUDA tensors stand in for the card's); off the route every module
keeps the eager ops, checked against them written out here; with the
route forced onto the CPU tensors every registered model's dense forward
is bit-equal to the eager one and calls the epilogue once a conv that
no other kernel fuses (yolov3 75, fcos 34, ResNet-101 85); the fake
implementation's shape, dtype and channels_last strides; the checks.

Card (skipped without a GPU, as in test_torch_port_cuda.py): the kernel
bit-equal to the eager epilogue for every activation and residual mode,
at the yolov3-416 and fcos-608 batch-32 shapes (C = 255 among them) and
in float32; a yolov3-416 Detector's dense outputs bit-equal with and
without the kernels, 75 launches a forward; an unfused fcos bottleneck
bit-equal to its plain version. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_epilogue.py
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from mydetection_tpu_torch import kernels  # noqa: E402
from mydetection_tpu_torch.kernels import epilogue, route  # noqa: E402
from mydetection_tpu_torch.kernels.epilogue import (  # noqa: E402
    ACT_LEAKY,
    ACT_NONE,
    ACT_RELU,
    conv_epilogue,
    conv_epilogue_plain,
)
from mydetection_tpu_torch.kernels.route import (  # noqa: E402
    kernels_enabled,
    plain_versions,
)
from mydetection_tpu_torch.models import layers  # noqa: E402
from mydetection_tpu_torch.models.darknet import ResBlock  # noqa: E402
from mydetection_tpu_torch.models.resnet import Bottleneck  # noqa: E402
from mydetection_tpu_torch.models.yolov3 import Branch  # noqa: E402
from mydetection_tpu_torch.registry import forward_dense, get_model  # noqa: E402

ACTS = {"none": ACT_NONE, "relu": ACT_RELU, "leaky": ACT_LEAKY}
RESIDUALS = ["none", "before", "after"]
# the epilogue launches of one dense forward, by registered name
LAUNCHES = {"yolov3": 75, "yolov3_608": 75, "rapid": 75, "fcos": 34,
            "retinanet": 34, "retinanet_r101": 85}


def _randomized(module: torch.nn.Module, seed: int = 0):
    """`module` with He-normal convs and every BN's four vectors drawn
    away from the identity, so each step of the epilogue shows."""
    layers.init_weights(module, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.BatchNorm):
                c = m.mean.shape
                m.scale.copy_(1 + 0.3 * torch.randn(c, generator=gen))
                m.bias.copy_(0.3 * torch.randn(c, generator=gen))
                m.mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.var.copy_(0.5 + torch.rand(c, generator=gen))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=gen))
    return module


def _eager_bn(x, bn):
    s = bn.scale * torch.rsqrt(bn.var + 1e-5)
    t = bn.bias - bn.mean * s
    return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


def _train_bn(x, bn):
    xf = x.float()
    n = x.numel() // x.shape[1]
    mean = xf.sum(dim=(0, 2, 3)) / n
    var = ((xf - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3)) / n
    s = bn.scale * torch.rsqrt(var + 1e-5)
    t = bn.bias - mean * s
    return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


def _leaky(y):
    return torch.where(y >= 0, y, 0.1 * y)


def _conv(x, conv_bn):
    w = conv_bn.conv.weight
    pad = (w.shape[2] - 1) // 2
    return torch.nn.functional.conv2d(x, w.to(x.dtype), stride=conv_bn.stride,
                                      padding=pad)


def _cbl(x, m, bn):
    return _leaky(bn(_conv(x, m), m.bn))


def _cbr(x, m, bn, relu=True):
    y = bn(_conv(x, m), m.bn)
    return torch.relu(y) if relu else y


# the eager ops each module ran before the epilogue kernel: (module, its
# arithmetic given a BN function)
def _modules():
    res = ResBlock(16)
    bott = Bottleneck(16, 32, 2, True)
    ident = Bottleneck(32, 32, 1, False)
    branch = Branch(16, 16, 18)
    cbl = layers.ConvBNLeaky(8, 16, 3, 2)
    cbr = layers.ConvBN(8, 16, 3)
    cb = layers.ConvBN(8, 16, 1, relu=False)
    return {
        "conv_bn_leaky": (cbl, 8, lambda x, bn: _cbl(x, cbl, bn)),
        "conv_bn_relu": (cbr, 8, lambda x, bn: _cbr(x, cbr, bn)),
        "conv_bn": (cb, 8, lambda x, bn: _cbr(x, cb, bn, relu=False)),
        "darknet_res_block": (res, 16, lambda x, bn: x + _cbl(
            _cbl(x, res.conv1, bn), res.conv2, bn)),
        "bottleneck_projection": (bott, 16, lambda x, bn: torch.relu(
            _cbr(_cbr(_cbr(x, bott.conv1, bn), bott.conv2, bn), bott.conv3,
                 bn, False) + _cbr(x, bott.down, bn, False))),
        "bottleneck_identity": (ident, 32, lambda x, bn: torch.relu(
            _cbr(_cbr(_cbr(x, ident.conv1, bn), ident.conv2, bn),
                 ident.conv3, bn, False) + x)),
        "yolov3_branch": (branch, 16, lambda x, bn: (
            _conv_out(_cbl(x, branch.conv, bn), branch.out)).permute(
                0, 2, 3, 1)),
    }


def _conv_out(y, conv):
    out = torch.nn.functional.conv2d(y, conv.weight.to(y.dtype))
    return out + conv.bias.to(out.dtype)[:, None, None]


def _forced_route(module, x):
    """`route.takes_kernel` without its device test: the route the
    card takes, on CPU tensors."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))
    return not module.training and not needs_grad and kernels_enabled()


@contextlib.contextmanager
def _counted(mp):
    """Count `epilogue.conv_epilogue`'s calls at the model's call sites."""
    calls = []
    inner = epilogue.conv_epilogue

    def count(*args, **kw):
        calls.append(args[0].shape)
        return inner(*args, **kw)

    mp.setattr(epilogue, "conv_epilogue", count)
    yield calls


# -- the route and the plain version on the CPU -----------------------------

@pytest.mark.parametrize("case", ["eval", "train", "grad", "plain", "cpu"])
def test_route_takes_only_eval_calls_on_the_card(case):
    """The kernel's route holds for an eval call on a CUDA tensor with no
    gradient needed outside `plain_versions()`, and for no other."""
    m = layers.ConvBNLeaky(4, 8, 1)
    m.train(case == "train").requires_grad_(case == "grad")
    ctx = plain_versions() if case == "plain" else contextlib.nullcontext()
    with FakeTensorMode(), ctx:
        x = torch.empty((2, 4, 5, 5), device="cpu" if case == "cpu"
                        else "cuda")
        taken = route.takes_kernel(m, x)
    assert taken == (case == "eval")


@pytest.mark.parametrize("mode", ["eval", "train", "grad", "plain"])
@pytest.mark.parametrize("name", sorted(_modules()))
def test_modules_off_the_card_keep_the_eager_ops(name, mode, monkeypatch):
    """On the CPU, in train mode, with a gradient needed and inside
    `plain_versions()` every routed module calls no kernel and returns
    the eager arithmetic it ran before the kernel, bit for bit."""
    module, c_in, eager = _modules()[name]
    module = _randomized(module)
    module.train(mode == "train").requires_grad_(mode == "grad")
    x = torch.randn((2, c_in, 9, 7), generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)

    def refuse(*args, **kw):
        raise AssertionError("the kernel's route was taken")

    monkeypatch.setattr(epilogue, "conv_epilogue", refuse)
    with plain_versions(mode == "plain"):
        got = module(x)
    assert torch.equal(got, eager(x, _train_bn if mode == "train"
                                  else _eager_bn))


@pytest.mark.parametrize("route_forced", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_bn_residual_joins_before_its_activation(relu, route_forced,
                                                       monkeypatch):
    """`ConvBN(x, residual=r)` is conv → BN → + r, then ReLU only when the
    module has `relu`, off the route and on it (forced onto CPU tensors,
    where the epilogue runs its plain version)."""
    m = _randomized(layers.ConvBN(8, 16, 3, relu=relu)).eval()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 8, 9, 7), generator=gen).to(torch.bfloat16)
    r = torch.randn((2, 16, 9, 7), generator=gen).to(torch.bfloat16)
    if route_forced:
        monkeypatch.setattr(route, "takes_kernel", _forced_route)
    with torch.no_grad(), _counted(monkeypatch) as calls:
        got = m(x, residual=r)
    want = _cbr(x, m, _eager_bn, False) + r
    assert torch.equal(got, torch.relu(want) if relu else want)
    assert len(calls) == int(route_forced)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_version_is_the_eager_epilogue(act, residual, dtype):
    """`conv_epilogue_plain` (what the kernel is held to) is the eager
    ops, BN and a bias alone, with the residual before or after the
    activation; the wrapper takes it on CPU tensors."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 24, 5, 6), generator=gen).to(dt)
    r = torch.randn((2, 24, 5, 6), generator=gen).to(dt)
    bn = layers.BatchNorm(24)
    bn = _randomized(bn.eval())
    fn = {"none": lambda y: y, "relu": torch.relu, "leaky": _leaky}[act]
    res = None if residual == "none" else r
    after = residual != "before"
    for scale in (bn.scale, None):
        args = ((bn.scale, bn.bias, bn.mean, bn.var) if scale is not None
                else (None, bn.bias, None, None))
        y = (_eager_bn(x, bn) if scale is not None
             else x + bn.bias.to(dt)[:, None, None])
        if residual == "before":
            y = y + r
        y = fn(y)
        if residual == "after":
            y = r + y
        with torch.no_grad():
            assert torch.equal(conv_epilogue_plain(x, *args, res, ACTS[act],
                                                   after), y)
            assert torch.equal(conv_epilogue(x, *args, res, ACTS[act], after),
                               y)


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_forced_route_is_bit_equal_and_counts(name, monkeypatch):
    """Every registered name's float32 64² dense forward with the
    kernel's route forced onto CPU tensors (so each call runs the plain
    version in the route's place) is bit-equal to the eager forward, and
    calls the epilogue once a conv that no other kernel fuses. The fused
    bottleneck is routed alike in both runs (its plain version)."""
    torch.manual_seed(0)
    model = get_model(name, input_size=64, compute_dtype=torch.float32)
    model.eval().requires_grad_(False)
    _randomized(model)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(Bottleneck, "takes_kernel",
                        lambda self, x: self.fused and not self.training)
    with torch.inference_mode():
        want = forward_dense(model, images)
        with _counted(monkeypatch) as calls:
            monkeypatch.setattr(route, "takes_kernel", _forced_route)
            got = forward_dense(model, images)
    assert len(calls) == LAUNCHES[name]
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_fake_gives_shape_dtype_and_channels_last():
    """The op's fake implementation (what `torch.export` and
    `FlopCounterMode` trace) gives x's shape and dtype in channels_last
    memory, whatever x's layout in the trace."""
    with FakeTensorMode():
        for dt, shape in ((torch.bfloat16, (32, 255, 52, 52)),
                          (torch.float32, (2, 64, 7, 9))):
            c = shape[1]
            vec = [torch.empty(c, device="cuda") for _ in range(4)]
            for x in (torch.empty(shape, dtype=dt, device="cuda"),
                      torch.empty(shape, dtype=dt, device="cuda",
                                  memory_format=torch.channels_last)):
                for res, mode in ((None, True), (x, False), (x, True)):
                    out = torch.ops.mydet.conv_epilogue(
                        x, *vec, res, ACT_LEAKY, mode)
                    assert out.shape == x.shape and out.dtype == dt
                    assert out.device.type == "cuda"
                    assert out.is_contiguous(memory_format=torch.channels_last)
            out = torch.ops.mydet.conv_epilogue(x, None, vec[1], None, None,
                                                None, ACT_NONE, True)
            assert out.shape == x.shape


@pytest.mark.parametrize("case", ["dtype", "partial_bn", "vector", "residual",
                                  "act", "channels"])
def test_checks_refuse_what_the_kernel_cannot_take(case):
    """`check_cuda`, which the launch and the fake implementation run."""
    c = 16
    x = torch.empty((2, c, 4, 4), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    vec = [torch.ones(c) for _ in range(4)]
    args = dict(x=x, scale=vec[0], bias=vec[1], mean=vec[2], var=vec[3],
                residual=None, act=ACT_RELU)
    if case == "dtype":
        args["x"] = x.half()
    elif case == "partial_bn":
        args["mean"] = None
    elif case == "vector":
        args["var"] = vec[3].double()
    elif case == "residual":
        args["residual"] = torch.empty((2, c, 4, 5), dtype=x.dtype)
    elif case == "act":
        args["act"] = 7
    else:
        args["x"] = torch.empty((1, epilogue.MAX_CHANNELS + 1, 1, 1),
                                dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        epilogue.check_cuda(**args)


# -- the kernel on the card -------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(shape, dtype, seed=0):
    """A conv-output-like x, a residual and BN vectors on the card, x and
    the residual channels_last."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    scale = 1 + 0.3 * torch.randn(c, generator=gen, device=dev)
    bias = 0.3 * torch.randn(c, generator=gen, device=dev)
    mean = 0.3 * torch.randn(c, generator=gen, device=dev)
    var = 0.5 + torch.rand(c, generator=gen, device=dev)
    return x, r, (scale, bias, mean, var)


# yolov3-416 and fcos-608 at batch 32 (the 208² and 104² maps, the head's
# 255 channels, ResNet's widest), rapid's 18 channels, and small maps
# whose size or channels take the element-wise and wrapping paths
CARD_SHAPES = [(32, 64, 208, 208), (32, 128, 104, 104), (32, 255, 52, 52),
               (32, 1024, 13, 13), (32, 2048, 19, 19), (32, 64, 304, 304),
               (4, 18, 32, 32), (3, 5, 7, 3), (2, 255, 3, 3), (1, 3, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_kernel_equals_eager_every_mode(cuda, act, residual):
    """Every activation and residual mode, BN and a bias alone, bf16 and
    float32, at a map whose channels and size take each of the kernel's
    three paths: bit-equal to the eager ops on the card."""
    res_after = residual != "before"
    for shape in ((4, 64, 17, 19), (4, 18, 16, 16), (3, 5, 7, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            x, r, bn = _card_case(shape, dtype)
            res = None if residual == "none" else r
            with torch.inference_mode():
                for args in (bn, (None, bn[1], None, None)):
                    before = conv_epilogue.launches
                    got = conv_epilogue(x, *args, res, ACTS[act], res_after)
                    want = conv_epilogue_plain(x, *args, res, ACTS[act],
                                               res_after)
                    assert conv_epilogue.launches == before + 1
                    assert got.is_contiguous(memory_format=torch.channels_last)
                    assert torch.equal(got, want), (shape, dtype, args[0] is None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_equals_eager_at_model_shapes(cuda, shape):
    """The path's shapes in bf16 (Darknet's leaky with the residual
    after, ResNet's relu with it before) and float32: bit-equal."""
    for dtype, act, after in ((torch.bfloat16, ACT_LEAKY, True),
                              (torch.bfloat16, ACT_RELU, False),
                              (torch.float32, ACT_LEAKY, True)):
        x, r, bn = _card_case(shape, dtype, seed=shape[1])
        with torch.inference_mode():
            got = conv_epilogue(x, *bn, r, act, after)
            want = conv_epilogue_plain(x, *bn, r, act, after)
        assert torch.equal(got, want), (dtype, act)


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_residual(cuda):
    """A residual view 2 bytes off a 16-byte boundary takes the element
    path, still bit-equal; an NCHW x is refused."""
    x, r, bn = _card_case((2, 16, 5, 5), torch.bfloat16)
    flat = torch.empty(r.numel() + 1, dtype=r.dtype, device="cuda")
    odd = flat[1:].view(2, 5, 5, 16).permute(0, 3, 1, 2)
    odd.copy_(r)
    with torch.inference_mode():
        got = conv_epilogue(x, *bn, odd, ACT_LEAKY, True)
        assert torch.equal(got, conv_epilogue_plain(x, *bn, r, ACT_LEAKY,
                                                    True))
        with pytest.raises(ValueError, match="channels_last"):
            conv_epilogue(x.contiguous(), *bn, None, ACT_LEAKY, True)


@pytest.mark.cuda
def test_kernel_raises_under_autograd(cuda):
    x, r, bn = _card_case((2, 16, 5, 5), torch.float32)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        conv_epilogue(x, *bn, None, ACT_RELU, True)


@pytest.mark.cuda
def test_yolov3_detector_dense_bit_equal_and_launches(cuda):
    """A yolov3-416 Detector at batch 32 on the card: the dense outputs
    with the kernels and with `plain_versions()` (the
    `use_pallas=False` route) bit-equal, and 75 epilogue launches a
    forward (72 conv-BN-leaky, 3 output biases), the fused bottleneck's
    and the chain's none."""
    from mydetection_tpu_torch import Detector

    det = Detector("yolov3", device="cuda", input_size=416, rng_seed=0)
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (32, 416, 416, 3), np.uint8)).cuda()
    with torch.inference_mode():
        kernels.reset_launches()
        got = det._forward_dense(images)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        with plain_versions():
            want = det._forward_dense(images)
    assert launches == {fn.__name__: 75 if fn is conv_epilogue else 0
                        for fn in kernels.KERNELS}
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_unfused_fcos_bottleneck_is_bit_equal(cuda, dtype):
    """ResNet-50 stage 2's block 0 (stride 2, the projection) and an
    identity block at fcos-608's 38² map, batch 32: four epilogue
    launches and three, bit-equal to the block's plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for block, c_in, side in ((Bottleneck(512, 1024, 2, True), 512, 76),
                              (Bottleneck(1024, 1024, 1, False), 1024, 38)):
        block = _randomized(block).eval().requires_grad_(False).cuda().to(
            memory_format=torch.channels_last)
        x = torch.randn((32, c_in, side, side), generator=gen,
                        device="cuda").to(dt).contiguous(
                            memory_format=torch.channels_last)
        with torch.inference_mode():
            before = conv_epilogue.launches
            got = block(x)
            n = conv_epilogue.launches - before
            with plain_versions():
                want = block(x)
        assert n == (4 if block.down is not None else 3)
        assert torch.equal(got, want)
