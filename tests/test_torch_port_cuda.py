"""The port on the card: the CUDA NMS (on chip, banded, every cluster
size), bias+GroupNorm+ReLU (forward, forward with statistics, fused
backward), rotated-NMS suppress, conv chain, row gather and fused
bottleneck kernels against their plain versions, the CUDA Detectors
(yolov3, fcos, rapid, retinanet, retinanet_r101) against the CPU ones,
the CUDA train steps of fcos, yolov3, rapid and retinanet against the
CPU ones, and a RetinaNet subnet's towers under autograd. Every test
skips on a host without a GPU. This file imports no JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files.)
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (  # noqa: E402
    GN_EDGE_SHAPES,
    GN_GROUPS,
    OLD_LARGEST_NMS_K,
    OLD_LARGEST_ROTATED_K,
    TRAIN_FAMILIES,
    bottleneck_case,
    bottleneck_error,
    check_parity,
    check_gn_train_case,
    compare_rotated,
    compare_train_step,
    gn_case,
    gn_error,
    gn_train_case,
    gn_train_error,
    golden_image,
    gather_cases,
    nms_cases,
    noise_canvas,
    padded_canvas,
    parity_train_run,
    rotated_cases,
    tower_case,
    tower_error,
    tower_ref_error,
)
from mydetection_tpu_torch import Detector, kernels  # noqa: E402
from mydetection_tpu_torch.kernels.bottleneck import (  # noqa: E402
    fused_bottleneck,
    fused_bottleneck_plain,
)
from mydetection_tpu_torch.kernels import gn  # noqa: E402
from mydetection_tpu_torch.kernels.gn import (  # noqa: E402
    bias_gn_relu,
    bias_gn_relu_bwd,
    bias_gn_relu_bwd_plain,
    bias_gn_relu_fwd_stats,
    bias_gn_relu_plain,
)
from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain  # noqa: E402
from mydetection_tpu_torch.kernels.gather import (  # noqa: E402
    gather_rows,
    gather_rows_plain,
)
from mydetection_tpu_torch.kernels.rotated_nms import (  # noqa: E402
    nms_from_iou_keep,
    nms_from_iou_keep_plain,
)
from mydetection_tpu_torch.kernels.tower import (  # noqa: E402
    conv3x3_chain,
    conv3x3_chain_plain,
    conv3x3_chain_reference,
)
from mydetection_tpu_torch.models.layers import init_weights  # noqa: E402
from mydetection_tpu_torch.ops.boxes import pairwise_iou  # noqa: E402
from mydetection_tpu_torch.registry import get_model  # noqa: E402

THR = 0.45
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,k", [(b, k) for b in (1, 12)
                                 for k in (200, 1024, 2048)]
                         + [(1, OLD_LARGEST_NMS_K), (6, OLD_LARGEST_NMS_K)])
def test_kernel_matches_plain(cuda, b, k):
    """chip_smoke's hard cases; K = 200 ends in a partial word, 1024 is
    the paths' (on chip), 2048 and the largest K the one-block kernel
    took are banded (the mask through a global scratch)."""
    boxes, valid = nms_cases(np.random.RandomState(k + b), b, k)
    bx = torch.from_numpy(boxes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = nms_keep.launches
    got = nms_keep(bx, v, THR)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  nms_keep_plain(bx, v, THR).cpu().numpy())


@pytest.mark.parametrize("thr", [THR, 0.0, -0.5])
def test_kernel_is_exact_at_touching_edges_and_any_threshold(cuda, thr):
    """Boxes in rows that touch edge to edge (intersection exactly 0),
    overlap by a sliver or repeat: the division-free IoU test bit-equal
    to plain at a positive, a zero and a negative threshold, where
    0 > thr suppresses every pair."""
    rng = np.random.RandomState(7)
    k = 300
    x = np.repeat(np.arange(30, dtype=np.float32) * 10, 10)[:k]
    y = np.tile(np.arange(10, dtype=np.float32) * 10, 30)[:k]
    boxes = np.stack([x, y, x + 10, y + 10], 1)
    sliver = rng.uniform(size=k) < 0.2
    boxes[sliver, 2] += np.float32(1e-3)
    dup = rng.uniform(size=k) < 0.2
    boxes[dup] = boxes[rng.randint(0, k, int(dup.sum()))]
    bx = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])).to(cuda)
    v = torch.from_numpy(rng.uniform(size=(2, k)) < 0.9).to(cuda)
    np.testing.assert_array_equal(nms_keep(bx, v, thr).cpu().numpy(),
                                  nms_keep_plain(bx, v, thr).cpu().numpy())


@pytest.mark.parametrize("kernel", ["nms", "rotated_nms"])
@pytest.mark.parametrize("k", [1, 33, 999])
def test_kernels_take_odd_k_and_empty_images(cuda, kernel, k):
    """K = 1, one past a word, and an odd K ending in a partial word,
    on an image with no valid box, one whose only valid box is the last
    and one all valid: both kernels bit-equal to plain, nothing kept
    where nothing is valid, the lone valid box and the top box kept."""
    rng = np.random.RandomState(k)
    xy = rng.uniform(0, 200, (3, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, (3, k, 2)).astype(np.float32)
    bx = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(cuda)
    valid = np.ones((3, k), bool)
    valid[0] = False
    valid[1, :-1] = False
    v = torch.from_numpy(valid).to(cuda)
    if kernel == "nms":
        got, ref = nms_keep(bx, v, THR), nms_keep_plain(bx, v, THR)
    else:
        iou = pairwise_iou(bx, bx).contiguous()
        got = nms_from_iou_keep(iou, v, THR)
        ref = nms_from_iou_keep_plain(iou, v, THR)
    assert torch.equal(got, ref)
    assert not got[0].any()
    assert got[1, -1] and int(got[1].sum()) == 1 and got[2, 0]


@pytest.mark.parametrize("cluster", [1, 2, 16])
def test_banded_plan_equals_on_chip(cuda, cluster):
    """At K = 1024 the banded resolve (mask through the global scratch,
    three ring stages) and the on-chip one give the same keep-set at
    every cluster size."""
    from mydetection_tpu_torch.kernels import nms as knms

    boxes, valid = nms_cases(np.random.RandomState(5), 12, 1024)
    bx = torch.from_numpy(boxes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    lib = knms._library()
    ref = nms_keep_plain(bx, v, THR)
    for stages in (0, 3):
        plan = knms.NMSPlan(cluster=cluster, stages=stages,
                            smem=knms.smem_bytes(1024, knms.BOX_FLOATS,
                                                 stages),
                            rows=-(-1024 // cluster),
                            scratch=knms.block_offset(32, 32) if stages else 0)
        keep = torch.empty_like(v)
        assert knms.launch(lib.nms_keep_launch, bx, v, keep, THR, plan) == 0
        assert torch.equal(keep, ref), (cluster, stages)


@pytest.mark.parametrize("kernel", ["nms", "rotated_nms"])
def test_plan_layout_matches_the_kernel(cuda, kernel):
    """`kernels.nms.smem_bytes` gives the bytes csrc/greedy_nms.cuh lays
    out, on chip and banded, at the paths' K and at the largest K each
    kernel takes."""
    from mydetection_tpu_torch.kernels import nms as knms
    from mydetection_tpu_torch.kernels import rotated_nms as krot

    lib = knms._library() if kernel == "nms" else krot._library()
    layout = (lib.nms_keep_layout_bytes if kernel == "nms"
              else lib.rotated_nms_layout_bytes)
    floats = knms.BOX_FLOATS if kernel == "nms" else 0
    for k in (1, 200, 512, 1024, 2048, 11360, 27680):
        for stages in (0, 2, 7):
            assert layout(k, stages) == knms.smem_bytes(k, floats, stages)


def test_kernel_rejects_bad_inputs(cuda):
    b = torch.zeros(2, 8, 4, device=cuda)
    v = torch.ones(2, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nms_keep(b.double(), v, THR)
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(b.transpose(0, 1), v.t(), THR)
    with pytest.raises(ValueError, match="valid"):
        nms_keep(b, v.cpu(), THR)
    with pytest.raises(ValueError, match="shared memory"):
        nms_keep(torch.zeros(1, 11361, 4, device=cuda),
                 torch.ones(1, 11361, dtype=torch.bool, device=cuda), THR)


@pytest.mark.parametrize("b,k", [(b, k) for b in (1, 12)
                                 for k in (200, 512, 2048)]
                         + [(12, OLD_LARGEST_ROTATED_K)])
def test_rotated_kernel_matches_plain(cuda, b, k):
    """chip_smoke's hard cases (near-threshold entries, an asymmetric
    matrix, all padding, few valid rows). K = 200 is not a multiple of
    32; 512 is rapid's (on chip); 2048 is banded; 1348 the largest K the
    one-block kernel took."""
    iou, valid = rotated_cases(np.random.RandomState(k + b), b, k,
                               device="cuda")
    before = nms_from_iou_keep.launches
    got = nms_from_iou_keep(iou, valid, THR)
    torch.cuda.synchronize()
    assert nms_from_iou_keep.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (b, k)
    np.testing.assert_array_equal(
        got.cpu().numpy(), nms_from_iou_keep_plain(iou, valid, THR).cpu().numpy())
    assert got.any()
    if b > 4:
        assert not got[4].any()


def test_rotated_kernel_reads_earlier_row_later_column(cuda):
    """On the asymmetric image the transposed matrix gives another
    keep-set, and the kernel follows the plain version on both."""
    iou, valid = rotated_cases(np.random.RandomState(3), 6, 128, device="cuda")
    m, v = iou[3:4], valid[3:4]
    t = m.transpose(1, 2).contiguous()
    a, b = nms_from_iou_keep(m, v, THR), nms_from_iou_keep(t, v, THR)
    assert not torch.equal(a, b)
    assert torch.equal(a, nms_from_iou_keep_plain(m, v, THR))
    assert torch.equal(b, nms_from_iou_keep_plain(t, v, THR))


@pytest.mark.parametrize("k", [512, 2048])
def test_rotated_kernel_nan_never_suppresses(cuda, k):
    """A third of the entries NaN: no NaN suppresses, on chip and
    banded."""
    iou, valid = rotated_cases(np.random.RandomState(11), 6, k,
                               device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(k)
    nan = torch.rand(iou.shape, device=cuda, generator=gen) < 0.33
    iou = iou.masked_fill(nan, float("nan")).contiguous()
    got = nms_from_iou_keep(iou, valid, THR)
    assert torch.equal(got, nms_from_iou_keep_plain(iou, valid, THR))
    clean = nms_from_iou_keep(iou.nan_to_num(0.0), valid, THR)
    assert torch.equal(got, clean)


def test_rotated_kernel_rejects_bad_inputs(cuda):
    iou = torch.zeros(2, 8, 8, device=cuda)
    v = torch.ones(2, 8, dtype=torch.bool, device=cuda)
    before = nms_from_iou_keep.launches
    with pytest.raises(ValueError, match="float32"):
        nms_from_iou_keep(iou.double(), v, THR)
    with pytest.raises(ValueError, match="contiguous"):
        nms_from_iou_keep(iou.transpose(1, 2), v, THR)
    with pytest.raises(ValueError, match="valid"):
        nms_from_iou_keep(iou, v.cpu(), THR)
    with pytest.raises(ValueError, match="valid"):
        nms_from_iou_keep(iou, v.float(), THR)
    with pytest.raises(ValueError, match="shared memory"):
        nms_from_iou_keep(torch.empty(1, 27681, 27681, device=cuda),
                          torch.ones(1, 27681, dtype=torch.bool, device=cuda),
                          THR)
    assert nms_from_iou_keep.launches == before


# (B, H, W): the five FCOS@608 levels at batch 8, a ragged one, a P3
# image at batch 1 and 32, and chip_smoke's GN_EDGE_SHAPES: a 19x19
# image its cluster does not split evenly
GN_SHAPES = [(8, 76, 76), (8, 38, 38), (8, 19, 19), (8, 10, 10), (8, 5, 5),
             (3, 5, 7), (1, 76, 76), (32, 76, 76), *GN_EDGE_SHAPES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_kernel_matches_plain(cuda, shape, dtype):
    """chip_smoke's gates: float32 max |d| <= 1e-5; bf16 within one bf16
    ulp (plus 1e-5 where the ReLU cuts)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    args = gn_case(gen, *shape, getattr(torch, dtype))
    before = bias_gn_relu.launches
    got = bias_gn_relu(*args, groups=GN_GROUPS)
    torch.cuda.synchronize()
    assert bias_gn_relu.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    err, ok = gn_error(got, bias_gn_relu_plain(*args, groups=GN_GROUPS))
    assert ok, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_kernel_takes_small_groups(cuda, dtype):
    """64 channels in 32 groups: 2 channels a group, fewer than a
    thread's 16-byte vector holds; the forward, the forward with
    statistics and the backward."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = gn_case(gen, 3, 5, 7, getattr(torch, dtype), c=64)
    err, ok = gn_error(bias_gn_relu(*args, groups=32),
                       bias_gn_relu_plain(*args, groups=32))
    assert ok, err
    x, bias, scale, shift = args
    y, mean, inv = bias_gn_relu_fwd_stats(x, bias, scale, shift, groups=32)
    dy = torch.randn(x.shape, device=cuda, generator=gen).to(x.dtype) \
        .contiguous(memory_format=torch.channels_last)
    got = bias_gn_relu_bwd(x, y, dy, bias, scale, mean, inv, groups=32)
    ref = bias_gn_relu_bwd_plain(x, y, dy, bias, scale, mean, inv, groups=32)
    for a, b in zip(got, ref):
        err, ok = gn_train_error(a, b)
        assert ok, err


def test_gn_fwd_is_bit_reproducible(cuda):
    """Every block adds the cluster's partials in rank order: five runs
    of the forward and of its statistics variant at the P3 shape give
    one set of bits."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    args = gn_case(gen, 8, 76, 76, torch.bfloat16)
    first = bias_gn_relu(*args, groups=GN_GROUPS)
    stats = bias_gn_relu_fwd_stats(*args, groups=GN_GROUPS)
    for _ in range(4):
        assert torch.equal(first, bias_gn_relu(*args, groups=GN_GROUPS))
        again = bias_gn_relu_fwd_stats(*args, groups=GN_GROUPS)
        assert all(torch.equal(u, v) for u, v in zip(stats, again))


def test_gn_refuses_what_cannot_launch(cuda):
    """A pixel row wider than the kernels take is refused by the plan,
    and a plan the kernel's layout disagrees with (or a cluster above
    16) by the launcher: each raises and counts no launch."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    x, bias, scale, shift = gn_case(gen, 2, 4, 4, torch.bfloat16, c=4096)
    before = (bias_gn_relu.launches, bias_gn_relu_fwd_stats.launches)
    with pytest.raises(ValueError, match="pixel row"):
        bias_gn_relu(x, bias, scale, shift, groups=GN_GROUPS)
    with pytest.raises(ValueError, match="pixel row"):
        bias_gn_relu_fwd_stats(x, bias, scale, shift, groups=GN_GROUPS)
    x, bias, scale, shift = gn_case(gen, 2, 38, 38, torch.bfloat16)
    out = torch.empty_like(x)
    plan = gn.plan_for("fwd", x, GN_GROUPS)
    for bad in (dataclasses.replace(plan, smem=plan.smem + 128),
                dataclasses.replace(plan, cluster=17, blocks=2 * 17)):
        with pytest.raises(RuntimeError, match="launch failed"):
            gn._launch_fwd(x, bias, scale, shift, out, None, GN_GROUPS, bad)
    assert (bias_gn_relu.launches, bias_gn_relu_fwd_stats.launches) == before


def test_gn_kernel_rejects_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x, bias, scale, shift = gn_case(gen, 2, 4, 4, torch.float32)
    before = bias_gn_relu.launches
    with pytest.raises(ValueError, match="channels_last"):
        bias_gn_relu(x.contiguous(), bias, scale, shift)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bias_gn_relu(x.half(), bias, scale, shift)
    with pytest.raises(ValueError, match="groups"):
        bias_gn_relu(x, bias, scale, shift, groups=3)
    with pytest.raises(ValueError, match="bias"):
        bias_gn_relu(x, bias.cpu(), scale, shift)
    with pytest.raises(ValueError, match="scale"):
        bias_gn_relu(x, bias, scale.bfloat16(), shift)
    assert bias_gn_relu.launches == before


def _cuda_vs_cpu(name, size, conf, canvas, info, kernel_launches):
    """Same seeded weights, float32 with TF32 off: the golden gates."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(input_size=size, compute_dtype=torch.float32, rng_seed=1)
        before = {k: k.launches for k in kernel_launches}
        gpu = Detector(name, device="cuda", **kw).detect_prepared(
            canvas[None], [info], conf_thres=conf)[0]
        for k, n in kernel_launches.items():
            assert k.launches == before[k] + n, k.__name__
        cpu = Detector(name, device="cpu", **kw).detect_prepared(
            canvas[None], [info], conf_thres=conf)[0]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert len(gpu) == len(cpu) > 0
    np.testing.assert_array_equal(gpu.classes, cpu.classes)
    np.testing.assert_allclose(gpu.scores, cpu.scores, rtol=0, atol=1e-4)
    if cpu.boxes_rot is not None:
        compare_rotated(gpu, cpu)
        return
    np.testing.assert_allclose(gpu.boxes_xyxy, cpu.boxes_xyxy, rtol=0,
                               atol=1e-2)


def test_cuda_detector_matches_cpu(cuda):
    canvas, info = padded_canvas(golden_image(), 416, 8, 58)
    _cuda_vs_cpu("yolov3", 416, 0.25, canvas, info,
                 {nms_keep: 1, fused_bottleneck: 0})


def test_cuda_fcos_detector_matches_cpu(cuda):
    """40 GN launches (8 tower GNs x 5 levels), one NMS launch and six
    fused bottlenecks (stage 0, stage 1's blocks 1-3)."""
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    _cuda_vs_cpu("fcos", 320, 0.005, canvas, info,
                 {nms_keep: 1, bias_gn_relu: 40, fused_bottleneck: 6})


def test_cuda_rapid_detector_matches_cpu(cuda):
    """One launch of the suppress kernel; boxes_rot within chip_smoke's
    rotated gates."""
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    _cuda_vs_cpu("rapid", 320, 0.3, canvas, info, {nms_from_iou_keep: 1,
                                                   nms_keep: 0,
                                                   fused_bottleneck: 0})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_train_kernels_match_plain(cuda, shape, dtype):
    """The forward-with-statistics kernel (y, mean, inv) and the fused
    backward (dx, dbias, dscale, dshift) within chip_smoke's gates of
    their plain versions, with a live ReLU mask; each twice, bit for
    bit. One launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 7)
    fwd_args, bwd_args = gn_train_case(gen, *shape, getattr(torch, dtype))
    before = (bias_gn_relu_fwd_stats.launches, bias_gn_relu_bwd.launches)
    check_gn_train_case(fwd_args, bwd_args)
    assert (bias_gn_relu_fwd_stats.launches, bias_gn_relu_bwd.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_bwd_takes_a_nchw_dy(cuda, dtype):
    """A contiguous NCHW dy (autograd may hand one over) gives the bits
    of its channels_last copy."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    _, (x, y, dy, bias, scale, mean, inv) = gn_train_case(
        gen, 3, 10, 10, getattr(torch, dtype), channels_last_dy=False)
    assert not dy.is_contiguous(memory_format=torch.channels_last)
    a = bias_gn_relu_bwd(x, y, dy, bias, scale, mean, inv, groups=GN_GROUPS)
    b = bias_gn_relu_bwd(x, y, dy.contiguous(memory_format=torch.channels_last),
                         bias, scale, mean, inv, groups=GN_GROUPS)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].is_contiguous(memory_format=torch.channels_last)


def test_gn_bwd_is_bit_reproducible(cuda):
    """No atomics: five runs at the P3 shape give one set of bits."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    _, args = gn_train_case(gen, 8, 76, 76, torch.bfloat16)
    first = bias_gn_relu_bwd(*args, groups=GN_GROUPS)
    for _ in range(4):
        again = bias_gn_relu_bwd(*args, groups=GN_GROUPS)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_gn_train_kernels_reject_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(13)
    (x, bias, scale, shift), (_, y, dy, _, _, mean, inv) = gn_train_case(
        gen, 2, 4, 4, torch.float32)
    before = (bias_gn_relu_fwd_stats.launches, bias_gn_relu_bwd.launches)
    with pytest.raises(ValueError, match="channels_last"):
        bias_gn_relu_fwd_stats(x.contiguous(), bias, scale, shift)
    with pytest.raises(ValueError, match="shift"):
        bias_gn_relu_fwd_stats(x, bias, scale, shift.cpu())
    with pytest.raises(ValueError, match="channels_last"):
        bias_gn_relu_bwd(x, y.contiguous(), dy, bias, scale, mean, inv)
    with pytest.raises(ValueError, match="dy"):
        bias_gn_relu_bwd(x, y, dy.bfloat16(), bias, scale, mean, inv)
    with pytest.raises(ValueError, match="mean"):
        bias_gn_relu_bwd(x, y, dy, bias, scale, mean.t(), inv)
    with pytest.raises(ValueError, match="groups"):
        bias_gn_relu_bwd(x, y, dy, bias, scale, mean, inv, groups=3)
    assert (bias_gn_relu_fwd_stats.launches,
            bias_gn_relu_bwd.launches) == before


@pytest.mark.parametrize("family", TRAIN_FAMILIES)
def test_cuda_train_step_matches_cpu(cuda, family):
    """Each family at 64², batch 2, float32 with TF32 off: the first
    step's loss terms, gradients, update and BN statistics within the
    CPU tests' gates; fcos launches each trainable GN kernel 40 times
    and no other kernel, the others launch none (the RetinaNet towers
    run the plain chain under autograd); the loss falls over four
    steps."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = parity_train_run(family, "cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    cpu = parity_train_run(family, "cpu")
    compare_train_step(gpu, cpu, family)
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    if family == "fcos":
        want.update(bias_gn_relu_fwd_stats=40, bias_gn_relu_bwd=40)
    assert gpu["launches"] == want
    assert gpu["totals"][-1] < gpu["totals"][0]


def test_fcos_detect_launches_no_train_kernel(cuda):
    """Detect runs under inference mode: the inference GN kernel 40
    times, the NMS and the class-row gather once, the fused bottleneck
    six times, the trainable GN kernels never."""
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    det = Detector("fcos", device="cuda", input_size=320, rng_seed=0)
    kernels.reset_launches()
    det.detect_prepared(canvas[None], [info], conf_thres=0.005)
    got = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(bias_gn_relu=40, nms_keep=1, gather_rows=1,
                fused_bottleneck=6)
    assert got == want


# (B, H, W, C): the five RetinaNet@608 levels at batch 32, and a ragged one
TOWER_SHAPES = [(32, 76, 76, 256), (32, 38, 38, 256), (32, 19, 19, 256),
                (32, 10, 10, 256), (32, 5, 5, 256), (2, 9, 13, 64)]


@pytest.fixture
def no_tf32():
    """The plain chain's float32 conv on cuDNN in full float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TOWER_SHAPES)
def test_tower_kernel_matches_plain(cuda, no_tf32, shape, dtype):
    """chip_smoke's gates, max-scaled: float32 2e-5, bf16 0.05; two runs
    bit for bit; one launch a call."""
    b, h, w, c = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    args = tower_case(gen, b, h, w, getattr(torch, dtype), c)
    before = conv3x3_chain.launches
    got = conv3x3_chain(*args)
    again = conv3x3_chain(*args)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches == before + 2
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)
    err, ok = tower_error(got, conv3x3_chain_plain(*args))
    assert ok, err


@pytest.mark.parametrize("dtype,c", [("float32", 32), ("bfloat16", 64)])
def test_tower_kernel_takes_one_and_three_layers(cuda, no_tf32, dtype, c):
    """An odd layer count ends in the output slab, not the scratch."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for layers in (1, 3):
        args = tower_case(gen, 2, 7, 5, getattr(torch, dtype), c,
                          layers=layers)
        err, ok = tower_error(conv3x3_chain(*args), conv3x3_chain_plain(*args))
        assert ok, (layers, err)


# bf16 (B, H, W, C) against the kernel-order reference: ragged M (tiles
# that cross image and row boundaries, a last tile past M) at C = 256
# and 64, two levels that take the 64 x 128 tile (P6 and P7 at batch
# 32) and one that takes the 128 x 256 tile in a partial wave (P5)
TOWER_REF_SHAPES = [(3, 7, 11, 256), (1, 5, 5, 64), (32, 10, 10, 256),
                    (32, 5, 5, 256), (32, 19, 19, 256)]


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("shape", TOWER_REF_SHAPES)
def test_tower_bf16_matches_reference(cuda, no_tf32, shape, layers):
    """chip_smoke's gates against conv3x3_chain_reference (one layer:
    one ulp + 1e-5 of max, element by element; more: max-scaled) and
    against the plain version (0.05); two runs bit for bit."""
    b, h, w, c = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + layers)
    args = tower_case(gen, b, h, w, torch.bfloat16, c, layers=layers)
    got = conv3x3_chain(*args)
    again = conv3x3_chain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.is_contiguous(memory_format=torch.channels_last)
    err, ok = tower_ref_error(got, conv3x3_chain_reference(*args), layers)
    assert ok, err
    err, ok = tower_error(got, conv3x3_chain_plain(*args))
    assert ok, err


@pytest.mark.parametrize("c", [32, 96])
def test_tower_bf16_takes_multiples_of_64(cuda, c):
    """The wgmma kernel's K chunk is 64 channels of one tap: bf16 with
    another C raises before anything launches."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    args = tower_case(gen, 1, 5, 5, torch.bfloat16, c)
    before = conv3x3_chain.launches
    with pytest.raises(ValueError, match="multiple of 64"):
        conv3x3_chain(*args)
    assert conv3x3_chain.launches == before


def test_tower_kernel_raises_under_autograd(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, packed, biases = tower_case(gen, 1, 5, 5, torch.float32, 16)
    before = conv3x3_chain.launches
    with pytest.raises(NotImplementedError, match="conv3x3_chain_plain"):
        conv3x3_chain(x.requires_grad_(), packed, biases)
    with torch.no_grad():
        conv3x3_chain(x, packed, biases)
    assert conv3x3_chain.launches == before + 1


def test_retinanet_subnet_trains_on_the_plain_chain(cuda, no_tf32):
    """A RetinaNet subnet under autograd on the card (float32, TF32 off,
    channels_last) launches no chain and gives the CPU's output and the
    CPU's gradients of its tower and output convs (1e-5 max-scaled)."""
    model = get_model("retinanet", num_classes=4,
                      compute_dtype=torch.float32, input_size=64)
    init_weights(model, 0)
    cpu = model.head.cls
    gpu = copy.deepcopy(cpu).to(cuda, memory_format=torch.channels_last)
    x = torch.randn(2, 256, 8, 8, generator=torch.Generator().manual_seed(8))
    runs = []
    for sub, xx in ((cpu, x), (gpu, x.to(cuda).contiguous(
            memory_format=torch.channels_last))):
        kernels.reset_launches()
        y = sub(xx.requires_grad_(), *sub.packed(torch.float32))
        grads = torch.autograd.grad(y.square().sum(),
                                    [xx, *sub.parameters()])
        runs.append((y.detach().cpu(), [g.cpu() for g in grads]))
        assert conv3x3_chain.launches == 0
    (y_cpu, g_cpu), (y_gpu, g_gpu) = runs
    assert float((y_gpu - y_cpu).abs().max() / y_cpu.abs().max()) <= 1e-5
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


def test_tower_kernel_rejects_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, packed, biases = tower_case(gen, 1, 5, 5, torch.float32, 32)
    before = conv3x3_chain.launches
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3_chain(x.contiguous(), packed, biases)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv3x3_chain(x.half(), packed.half(), biases)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv3x3_chain(x[:, :24], packed[:, :216, :24], biases[:, :24])
    with pytest.raises(ValueError, match="packed"):
        conv3x3_chain(x, packed.bfloat16(), biases)
    with pytest.raises(ValueError, match="biases"):
        conv3x3_chain(x, packed, biases.cpu())
    assert conv3x3_chain.launches == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("c", [80, 7])
def test_gather_kernel_matches_plain(cuda, dtype, c):
    """Bit-equal on chip_smoke's index sets (sorted with duplicates,
    top-k order, all equal), int64 and int32; C = 7 rows break 16-byte
    alignment; a strided index view (a top-k's prefix) too."""
    src = torch.randn(4, 5000, c, device=cuda).to(getattr(torch, dtype))
    for sel in gather_cases(np.random.RandomState(c), 4, 5000, 700).values():
        for idx in (torch.from_numpy(sel).to(cuda),
                    torch.from_numpy(sel).to(cuda).int()):
            before = gather_rows.launches
            got = gather_rows(src, idx)
            assert gather_rows.launches == before + 1
            assert torch.equal(got, gather_rows_plain(src, idx))
    _, order = torch.sort(src.float().amax(-1), dim=1, descending=True)
    assert torch.equal(gather_rows(src, order[:, :300]),
                       gather_rows_plain(src, order[:, :300]))


def test_gather_kernel_rejects_bad_inputs(cuda):
    src = torch.zeros(2, 10, 8, device=cuda)
    sel = torch.zeros(2, 4, dtype=torch.long, device=cuda)
    before = gather_rows.launches
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(src.transpose(1, 2), sel)
    with pytest.raises(ValueError, match="int64 or int32"):
        gather_rows(src, sel.float())
    with pytest.raises(ValueError, match="sel"):
        gather_rows(src, sel.cpu())
    with pytest.raises(ValueError, match="unit stride"):
        gather_rows(src, sel.t().contiguous().t())
    assert gather_rows.launches == before


def test_cuda_retinanet_detector_matches_cpu(cuda, no_tf32):
    """chip_smoke's retinanet parity: a 320² noise canvas, float32,
    counts and classes equal, scores within 1e-4, boxes within 1e-2 px
    plus twice the CPU's own float32 error (the largest distance of its
    boxes from a float64 run's), row by row or by a one-to-one match;
    the CUDA run launches the NMS once, the chain 10 times and the
    gather once, the fused bottleneck six times."""
    check_parity("retinanet", *noise_canvas(320), 0.005,
                 {nms_keep: 1, conv3x3_chain: 10, gather_rows: 1,
                  fused_bottleneck: 6}, box_floor=True)


def test_cuda_retinanet_r101_detector_matches_cpu(cuda, no_tf32):
    """The same parity for ResNet-101: six fused bottlenecks too (the
    deeper stage 2 stays on cuDNN)."""
    check_parity("retinanet_r101", *noise_canvas(320), 0.005,
                 {nms_keep: 1, conv3x3_chain: 10, gather_rows: 1,
                  fused_bottleneck: 6}, box_floor=True)


def test_retinanet_detect_launches(cuda):
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    det = Detector("retinanet", device="cuda", input_size=320, rng_seed=0)
    kernels.reset_launches()
    dets = det.detect_prepared(canvas[None], [info], conf_thres=0.005)
    got = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(nms_keep=1, conv3x3_chain=10, gather_rows=1,
                fused_bottleneck=6)
    assert got == want
    assert len(dets[0]) > 0 and np.isfinite(dets[0].boxes_xyxy).all()


# (B, H, W, c_in, c_out): the routed 608 block shapes at batch 4, ragged
# maps with and without a projection (a width that is not a multiple of
# the 16-pixel tile), and for the persistent bf16 kernel and TMA's zero
# fill: one tile, a 1 x 1 map, fewer tiles than SMs at c_mid 128
BOTTLENECK_SHAPES = [(4, 152, 152, 64, 256), (4, 152, 152, 256, 256),
                     (4, 76, 76, 512, 512), (2, 9, 13, 64, 256),
                     (2, 9, 13, 512, 512), (3, 17, 5, 256, 256),
                     (1, 8, 16, 256, 256), (1, 1, 1, 512, 512),
                     (1, 9, 13, 512, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BOTTLENECK_SHAPES)
def test_bottleneck_kernel_matches_plain(cuda, no_tf32, shape, dtype):
    """chip_smoke's gates, max-scaled: float32 2e-5, bf16 0.02; two runs
    bit for bit; one launch a call."""
    b, h, w, c_in, c_out = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, f = bottleneck_case(gen, b, h, w, c_in, c_out, getattr(torch, dtype))
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, *f)
    again = fused_bottleneck(x, *f)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 2
    assert got.dtype == x.dtype and got.shape == (b, c_out, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)
    err, ok = bottleneck_error(got, fused_bottleneck_plain(x, *f))
    assert ok, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottleneck_kernel_zeroes_the_halo(cuda, no_tf32, dtype):
    """BN biases of 3 make relu(b1') large: a halo pixel computed as
    relu(b1') instead of zero would move every border output."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x, f = bottleneck_case(gen, 2, 9, 13, 64, 256, getattr(torch, dtype),
                           bn_bias=3.0)
    err, ok = bottleneck_error(fused_bottleneck(x, *f),
                               fused_bottleneck_plain(x, *f))
    assert ok, err


def test_bottleneck_kernel_raises_under_autograd(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, f = bottleneck_case(gen, 1, 5, 5, 256, 256, torch.float32)
    before = fused_bottleneck.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_bottleneck(x.requires_grad_(), *f)
    with torch.no_grad():
        fused_bottleneck(x, *f)
    assert fused_bottleneck.launches == before + 1


def test_bottleneck_kernel_rejects_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(10)
    x, f = bottleneck_case(gen, 1, 5, 5, 64, 256, torch.float32)
    before = fused_bottleneck.launches
    with pytest.raises(ValueError, match="channels_last"):
        fused_bottleneck(x.contiguous(), *f)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_bottleneck(x.half(), *f)
    with pytest.raises(ValueError, match="c_mid"):
        fused_bottleneck(x, f.w1[:, :32].contiguous(), f.b1[:32],
                         *f[2:])
    with pytest.raises(ValueError, match="both wd and bd"):
        fused_bottleneck(x, *f[:7])
    with pytest.raises(ValueError, match="must equal c_out"):
        fused_bottleneck(x, *f[:6])
    with pytest.raises(ValueError, match="w2"):
        fused_bottleneck(x, *f[:2], f.w2.bfloat16(), *f[3:])
    with pytest.raises(ValueError, match="b3"):
        fused_bottleneck(x, *f[:5], f.b3.cpu(), *f[6:])
    assert fused_bottleneck.launches == before
