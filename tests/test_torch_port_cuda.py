"""The port on the card: the CUDA NMS (on chip, banded, every cluster
size), bias+GroupNorm+ReLU (forward, forward with statistics, fused
backward), rotated-NMS suppress, conv chain, row gather and fused
bottleneck kernels against their plain versions, the CUDA Detectors
(yolov3 at 416 and yolov3_608 at 608, fcos, rapid, retinanet,
retinanet_r101) against the CPU ones,
the CUDA train steps of fcos, yolov3, rapid and retinanet against the
CPU ones, the data-parallel fcos step on two replicas of one card
against the one-device step, and a RetinaNet subnet's towers under
autograd. Every test
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
    EVAL_F32_SCALE,
    GN_EDGE_SHAPES,
    GN_GROUPS,
    OLD_LARGEST_NMS_K,
    OLD_LARGEST_ROTATED_K,
    PARITY_CLASSES,
    PARITY_SIZE,
    TRAIN_FAMILIES,
    bottleneck_case,
    bottleneck_error,
    check_parity,
    check_gn_train_case,
    compare_rotated,
    compare_train_step,
    dp_devices,
    dp_pair,
    first_step,
    gn_case,
    gn_error,
    gn_train_case,
    gn_train_error,
    golden_image,
    gather_cases,
    nms_cases,
    noise_canvas,
    padded_canvas,
    parity_cases,
    parity_train_run,
    rotated_cases,
    tower_case,
    tower_error,
    tower_ref_error,
    train_batch,
)
from mydetection_tpu_torch import Detector, kernels  # noqa: E402
from mydetection_tpu_torch.kernels.bottleneck import (  # noqa: E402
    fused_bottleneck,
    fused_bottleneck_plain,
)
from mydetection_tpu_torch.kernels.epilogue import conv_epilogue  # noqa: E402
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
                 {nms_keep: 1, fused_bottleneck: 0, conv_epilogue: 75})


def test_cuda_yolov3_608_detector_matches_cpu(cuda, no_tf32):
    """yolov3_608 at its registered size on the golden image letterboxed
    to 608: chip_smoke's parity (float32, TF32 off, the same seeded
    weights; counts and classes equal, scores within 1e-4, boxes within
    1e-2 px, row by row or by a one-to-one match), one NMS launch and 75
    conv epilogues."""
    check_parity("yolov3_608", *parity_cases()["yolov3_608"],
                 {nms_keep: 1, fused_bottleneck: 0, conv_epilogue: 75})


def test_cuda_fcos_detector_matches_cpu(cuda):
    """40 GN launches (8 tower GNs x 5 levels), one NMS launch, six
    fused bottlenecks (stage 0, stage 1's blocks 1-3) and 34 conv
    epilogues (the stem and the unfused blocks' convs)."""
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    _cuda_vs_cpu("fcos", 320, 0.005, canvas, info,
                 {nms_keep: 1, bias_gn_relu: 40, fused_bottleneck: 6,
                  conv_epilogue: 34})


def test_cuda_rapid_detector_matches_cpu(cuda):
    """One launch of the suppress kernel; boxes_rot within chip_smoke's
    rotated gates."""
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    _cuda_vs_cpu("rapid", 320, 0.3, canvas, info, {nms_from_iou_keep: 1,
                                                   nms_keep: 0,
                                                   fused_bottleneck: 0,
                                                   conv_epilogue: 75})


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_data_parallel_fcos_step_equals_one_device(cuda, dtype):
    """fcos at 64², batch 4, over `dp_devices()` (two replicas on one
    card, one a card where there are more) against the one-device step
    from the same seeded weights and batch: each replica launches each
    trainable GN kernel 40 times; in float32 (TF32 off) the first
    step's loss terms, gradients, update and BN statistics are within
    the TRAIN_* gates; the replicas are bit-equal after it; in bf16 the
    loss terms are finite."""
    n = len(dp_devices())
    batch = train_batch(0, 4, PARITY_SIZE, PARITY_CLASSES)
    dt = getattr(torch, dtype)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one, dp = dp_pair(PARITY_SIZE, dt)
        ref = first_step(one, batch)
        got = first_step(dp, batch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    per_step = {fn.__name__: 0 for fn in kernels.KERNELS}
    per_step.update(bias_gn_relu_fwd_stats=40, bias_gn_relu_bwd=40)
    assert ref["launches"] == per_step
    assert got["launches"] == {k: n * v for k, v in per_step.items()}
    states = [m.state_dict() for m in dp.replicas]
    for other in states[1:]:
        for k, v in states[0].items():
            assert torch.equal(v, other[k]), k
    if dtype == "float32":
        compare_train_step(got, ref, "fcos")
    else:
        assert np.isfinite(list(got["terms"].values())).all()


def test_fcos_detect_launches_no_train_kernel(cuda):
    """Detect runs under inference mode: the inference GN kernel 40
    times, the NMS and the class-row gather once, the fused bottleneck
    six times, the conv epilogue 34, the trainable GN kernels never."""
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    det = Detector("fcos", device="cuda", input_size=320, rng_seed=0)
    kernels.reset_launches()
    det.detect_prepared(canvas[None], [info], conf_thres=0.005)
    got = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(bias_gn_relu=40, nms_keep=1, gather_rows=1,
                fused_bottleneck=6, conv_epilogue=34)
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
                  fused_bottleneck: 6, conv_epilogue: 34}, box_floor=True)


def test_cuda_retinanet_r101_detector_matches_cpu(cuda, no_tf32):
    """The same parity for ResNet-101: six fused bottlenecks too (the
    deeper stage 2 stays on cuDNN, each conv followed by the epilogue:
    85)."""
    check_parity("retinanet_r101", *noise_canvas(320), 0.005,
                 {nms_keep: 1, conv3x3_chain: 10, gather_rows: 1,
                  fused_bottleneck: 6, conv_epilogue: 85}, box_floor=True)


def test_retinanet_detect_launches(cuda):
    canvas, info = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    det = Detector("retinanet", device="cuda", input_size=320, rng_seed=0)
    kernels.reset_launches()
    dets = det.detect_prepared(canvas[None], [info], conf_thres=0.005)
    got = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(nms_keep=1, conv3x3_chain=10, gather_rows=1,
                fused_bottleneck=6, conv_epilogue=34)
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


# -- the host data layer and evaluation on the card -----------------------------

@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    from chip_smoke import write_coco_set

    root = tmp_path_factory.mktemp("cuda_coco")
    ann, _ = write_coco_set(str(root), n=10)
    return str(root), ann


def test_loaders_on_the_card_equal_the_cpu(cuda, coco_set):
    """StreamingPipeline and TrainLoader batches on the card: CUDA
    uint8 tensors equal to the CPU ones (the GT stays numpy)."""
    import json
    import os

    from mydetection_tpu_torch.data.coco import CocoDataset
    from mydetection_tpu_torch.data.loader import StreamingPipeline, TrainLoader

    root, ann = coco_set
    paths = [os.path.join(root, im["file_name"])
             for im in json.load(open(ann))["images"]]
    kw = dict(input_size=96, batch_size=4, num_threads=3, native=False)
    gpu = list(StreamingPipeline(paths, **kw))
    cpu = list(StreamingPipeline(paths, device="cpu", **kw))
    assert len(gpu) == len(cpu) == 3
    for (g, gi, gp), (c, ci, cp) in zip(gpu, cpu):
        assert g.is_cuda and g.dtype == torch.uint8 and g.shape == (4, 96, 96, 3)
        assert torch.equal(g.cpu(), c) and gi == ci and gp == cp
    ds = CocoDataset(ann, root)
    kw = dict(batch_size=4, sizes=[64, 96], rescale_every=1, seed=3,
              num_threads=3)
    gpu = list(TrainLoader(ds, **kw).epoch(1))
    cpu = list(TrainLoader(ds, device="cpu", **kw).epoch(1))
    assert len(gpu) == len(cpu) == 3
    for g, c in zip(gpu, cpu):
        assert g[0].is_cuda and g[0].dtype == torch.uint8
        assert torch.equal(g[0].cpu(), c[0]) and g[4] == c[4]
        for x, y in zip(g[1:4], c[1:4]):
            assert isinstance(x, np.ndarray)
            np.testing.assert_array_equal(x, y)


def test_evaluate_detector_on_the_card_equals_the_cpu(cuda, coco_set,
                                                      tmp_path):
    """yolov3 at 64², float32 with TF32 off, the same seeded weights
    (conv kernels times EVAL_F32_SCALE, so the scores are not all 1.0):
    the card's result rows equal the CPU's under the detect parity
    gates, one to one and tie-aware, and the stats agree."""
    import json

    from chip_smoke import (
        EVAL_F32_SCALE,
        PARITY_BOX_GATE,
        match_detections,
        rows_to_detections,
    )
    from mydetection_tpu_torch.convert import to_jax_params
    from mydetection_tpu_torch.eval.evaluator import evaluate_detector
    from mydetection_tpu_torch.evaluate import tf32_off

    root, ann = coco_set
    gt = json.load(open(ann))
    kw = dict(input_size=64, num_classes=3, compute_dtype=torch.float32)
    seeded = Detector("yolov3", device="cpu", rng_seed=2, **kw).model
    params = to_jax_params({k: v * EVAL_F32_SCALE if v.dim() == 4 else v
                            for k, v in seeded.state_dict().items()})
    out = {}
    with tf32_off("cuda"):
        for device in ("cuda", "cpu"):
            det = Detector("yolov3", device=device, params=params, **kw)
            path = str(tmp_path / f"{device}.json")
            before = nms_keep.launches
            stats = evaluate_detector(det, ann, root, batch_size=4,
                                      conf_thres=0.3, results_path=path,
                                      verbose=False)
            launched = nms_keep.launches - before
            out[device] = (stats, json.load(open(path)), launched)
    (g_stats, g_rows, g_n), (c_stats, c_rows, c_n) = out["cuda"], out["cpu"]
    assert (g_n, c_n) == (3, 0)   # one NMS launch a batch, on the card only
    assert len(g_rows) == len(c_rows) > 0
    ids = [im["id"] for im in gt["images"]]
    for g, c in zip(rows_to_detections(g_rows, ids),
                    rows_to_detections(c_rows, ids)):
        assert len(g) == len(c) and match_detections(g, c, PARITY_BOX_GATE)
    for k in c_stats:
        assert abs(g_stats[k] - c_stats[k]) <= 1e-3, (k, g_stats, c_stats)


# ---------------------------------------------------------------------------
# the int8 serving path (quant.py, quant_resnet.py)
# ---------------------------------------------------------------------------

# (B, H, W) of the int8 conv cases: 7x11 maps, maps of 16 output rows or
# fewer (the CUDA GEMM takes 17 and up, so they are padded), and a
# stage-size map
CONV_I8_SHAPES = [(2, 7, 11), (1, 3, 5), (1, 1, 1), (4, 64, 64)]
# the int8 forward, card against CPU (128², float32, TF32 off, one set of
# quantized params on both; test_int8_forward_matches_cpu): the gates
# are the measured values less a margin (PERF.md §2)
# measured on an H100 (PERF.md): the region alone bit-equal on darknet
# and retinanet (raw heads 0 and 1.8e-6), fcos 0.9925 equal after its
# GN kernels (raw 0.0041); the whole forward's least share yolov3
# 0.764, rapid 0.760, fcos 0.9925, retinanet 1.0, least cosine 0.9946
# (yolov3's classes), 0.99995, 0.999999997, 0.9999999999999
QUANT_PARITY_GN_EQUAL = 0.98    # region alone, after fcos's GN kernels
QUANT_REGION_RAW = {"yolov3": 1e-4, "rapid": 1e-4, "fcos": 0.02,
                    "retinanet": 1e-4}   # region alone, max-scaled
QUANT_PARITY_EQUAL = {"yolov3": 0.66, "rapid": 0.66, "fcos": 0.98,
                      "retinanet": 0.99}
QUANT_PARITY_COSINE = {"yolov3": 0.99, "rapid": 0.999, "fcos": 0.9999,
                       "retinanet": 0.9999}
QUANT_LAUNCHES = {
    "yolov3": {"nms_keep": 1, "conv_epilogue": 5},
    "rapid": {"nms_from_iou_keep": 1, "conv_epilogue": 5},
    "fcos": {"nms_keep": 1, "bias_gn_relu": 40, "gather_rows": 1,
             "conv_epilogue": 1},
    "retinanet": {"nms_keep": 1, "gather_rows": 1, "conv_epilogue": 1},
    "retinanet_r101": {"nms_keep": 1, "gather_rows": 1, "conv_epilogue": 1},
}


@pytest.mark.parametrize("ksize,stride,pad", [(k, s, p) for k in (1, 3)
                                              for s in (1, 2)
                                              for p in (None, -37)])
@pytest.mark.parametrize("shape", CONV_I8_SHAPES)
def test_conv_i8_matches_cpu(cuda, shape, ksize, stride, pad):
    """The im2col + torch._int_mm conv bit-equal (int32) on the card and
    on the CPU, zero and zero-point padding."""
    from mydetection_tpu_torch import quant

    b, h, w = shape
    g = torch.Generator().manual_seed(ksize * 10 + stride + h)
    x = torch.randint(-128, 128, (b, 64, h, w), dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (32, ksize, ksize, 64), dtype=torch.int8,
                       generator=g)
    zp = None if pad is None else torch.tensor(pad, dtype=torch.int8)
    want = quant._conv_i8(x, wq, stride=stride, pad_val=zp)
    got = quant._conv_i8(x.to(cuda).contiguous(
        memory_format=torch.channels_last), wq.to(cuda), stride=stride,
        pad_val=None if zp is None else zp.to(cuda))
    assert got.dtype == torch.int32 and got.is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(got.cpu(), want)


def _recording(fn):
    """fn() with every requantized int8 activation recorded (on the
    host), in call order."""
    from mydetection_tpu_torch import quant, quant_resnet

    seen, orig = [], quant._quant

    def rec(y, sm):
        out = orig(y, sm)
        seen.append(out.cpu())
        return out

    quant._quant = quant_resnet._quant = rec
    try:
        with torch.inference_mode():
            return fn(), seen
    finally:
        quant._quant = quant_resnet._quant = orig


def _region(qp, y, cfg):
    """The int8 region alone from the prologue output `y`."""
    from mydetection_tpu_torch import quant, quant_resnet

    if isinstance(qp, quant.QuantizedParams):
        return quant._region(quant._QuantBE(qp.scales, torch.float32),
                             qp.qb, qp.qh, y)
    return quant_resnet._region(quant_resnet._QuantBE(qp.scales,
                                                      torch.float32),
                                qp.qb, qp.qf, qp.qh, y, cfg=cfg)


def _prologue(qp, images):
    from mydetection_tpu_torch import quant, quant_resnet

    mod = quant if isinstance(qp, quant.QuantizedParams) else quant_resnet
    with torch.inference_mode():
        return mod._prologue(qp.backbone_float, images, torch.float32)


def _closeness(got: dict, want: dict) -> dict:
    out = {}
    for k in want:
        a = got[k].float().cpu().double().flatten()
        b = want[k].float().cpu().double().flatten()
        out[k] = (float(a @ b / (a.norm() * b.norm())),
                  float((a - b).norm() / b.norm()))
    return out


@pytest.mark.parametrize("name", ["yolov3", "rapid", "fcos", "retinanet"])
def test_int8_forward_matches_cpu(cuda, no_tf32, tmp_path, name):
    """One set of quantized params (the seeded CPU model, conv kernels
    x 0.7 as in chip_smoke's float32 evaluate check, calibrated on the
    CPU and saved) on the card and on the CPU, 128², float32, two noise
    canvases.

    The int8 region alone, from the CPU's prologue output on both: every
    requantized int8 activation bit-equal where no GN sits before it
    (the int8 GEMM and the float32 epilogue are exact and elementwise),
    the share after fcos's GN kernels (sums in another order than the
    CPU plain version's) at least QUANT_PARITY_GN_EQUAL, the raw heads
    within QUANT_REGION_RAW of their largest |value| (the float output
    convs on cuDNN; on fcos also the steps after its GN).

    The whole forward, each device with its own prologue: there float32
    rounding of the prologue moves values across rounding ties and the
    int8 chain carries the steps on (furthest through Darknet's 67
    requantizations): each key's share of equal int8 values at least
    QUANT_PARITY_EQUAL[name], the dense outputs' cosine at least
    QUANT_PARITY_COSINE[name]."""
    from mydetection_tpu_torch import quant

    kw = dict(input_size=128, compute_dtype=torch.float32)
    cpu = Detector(name, device="cpu", rng_seed=0, **kw)
    with torch.no_grad():
        for p in cpu.model.parameters():
            if p.dim() == 4:
                p.mul_(EVAL_F32_SCALE)
    rng = np.random.RandomState(0)
    qp = quant.quantize_model(cpu.model, [rng.randint(
        0, 256, (2, 128, 128, 3), np.uint8) for _ in range(2)])
    path = str(tmp_path / "q.npz")
    quant.save_quantized(path, qp, cpu.cfg)
    card = quant.load_quantized(path, cpu.cfg, device="cuda")
    images = torch.from_numpy(np.stack([noise_canvas(128, s)[0]
                                        for s in (1, 2)]))
    y = _prologue(qp, images)
    want_raw, want_q = _recording(lambda: _region(qp, y, cpu.cfg))
    got_raw, got_q = _recording(lambda: _region(
        card, y.to(cuda).contiguous(memory_format=torch.channels_last),
        cpu.cfg))
    assert len(got_q) == len(want_q) > 60
    equal = [float((a == b).float().mean()) for a, b in zip(got_q, want_q)]
    raw_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(got_raw, want_raw))
    want, want_q = _recording(
        lambda: quant.forward_dense_quantized(qp, images, cpu.cfg))
    got, got_q = _recording(
        lambda: quant.forward_dense_quantized(card, images.to(cuda), cpu.cfg))
    whole = [float((a == b).float().mean()) for a, b in zip(got_q, want_q)]
    close = _closeness(got, want)
    print(f"int8 parity {name}: region min equal share {min(equal):.6f}, "
          f"raw max-scaled {raw_err:.3g}; whole forward min share "
          f"{min(whole):.6f}, mean {np.mean(whole):.6f}, dense (cos, rel) "
          f"{close}")
    if name == "fcos":
        assert min(equal) >= QUANT_PARITY_GN_EQUAL, equal
    else:
        assert min(equal) == 1.0, equal
    assert raw_err <= QUANT_REGION_RAW[name], raw_err
    assert min(whole) >= QUANT_PARITY_EQUAL[name], whole
    for k, (cos, _) in close.items():
        assert cos >= QUANT_PARITY_COSINE[name], (k, close)


@pytest.mark.parametrize("name", sorted(QUANT_LAUNCHES))
def test_int8_detect_launches(cuda, name):
    """The int8 detect at 320, batch 2, launches exactly its path's
    kernels: the NMS (rapid: the suppress kernel), the gather on the
    multi-label families and, on fcos, the GN kernel 40 times at
    float32, the conv epilogue in the float prologue (Darknet's stem to
    stage 1's downsample, 5; ResNet's stem, 1); never the conv chain or
    the fused bottleneck."""
    det = Detector(name, device="cuda", input_size=320, rng_seed=0,
                   quantized=True)
    canvases = np.stack([noise_canvas(320, s)[0] for s in (1, 2)])
    infos = [noise_canvas(320, s)[1] for s in (1, 2)]
    kernels.reset_launches()
    dets = det.detect_prepared(canvases, infos, conf_thres=det.cfg.conf_thres
                               if name in ("yolov3", "rapid") else 0.005)
    got = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(QUANT_LAUNCHES[name])
    assert got == want
    assert all(np.isfinite(d.boxes_xyxy).all() for d in dets)


# -- the custom ops, export and FLOPs on the card ------------------------


def op_cases(dev):
    """Small inputs for each `mydet::` op, on `dev`: (name, args)."""
    gen = torch.Generator(device=dev.type).manual_seed(0)
    boxes, valid = nms_cases(np.random.RandomState(0), 2, 200)
    iou, rvalid = rotated_cases(np.random.RandomState(0), 2, 96,
                                device=dev.type)
    x, f = bottleneck_case(gen, 2, 9, 13, 64, 256, torch.bfloat16,
                           device=dev.type)
    tx, packed, biases = tower_case(gen, 2, 9, 13, torch.bfloat16, c=64,
                                    device=dev.type)
    gn_args = tuple(torch.randn(64, generator=gen, device=dev)
                    for _ in range(3))
    gx = torch.randn(2, 64, 11, 13, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    src = torch.randn(2, 300, 80, generator=gen, device=dev)
    sel = torch.randint(0, 300, (2, 64), generator=gen, device=dev)
    return [
        ("nms_keep", (torch.from_numpy(boxes).to(dev),
                      torch.from_numpy(valid).to(dev), THR)),
        ("nms_from_iou_keep", (iou.contiguous(), rvalid.contiguous(), THR)),
        ("bias_gn_relu", (gx, *gn_args, 32)),
        ("conv3x3_chain", (tx, packed, biases)),
        ("fused_bottleneck", (x, *f)),
        ("gather_rows", (src, sel)),
        ("conv_epilogue", (gx, *gn_args, gn_args[0].abs() + 0.5, gx, 2,
                           True)),
    ]


@pytest.mark.parametrize("index", range(7))
def test_custom_op_fake_matches_real(cuda, index):
    """`torch.library.opcheck` on each op: its schema, its fake
    implementation's shapes, dtypes and strides against the real one's,
    and its tracing through AOT dispatch."""
    from mydetection_tpu_torch.kernels import ops

    name, args = op_cases(cuda)[index]
    assert f"mydet::{name}" in ops.OP_NAMES
    torch.library.opcheck(getattr(torch.ops.mydet, name).default, args)


def export_pair(name, tmp_path, **kw):
    from mydetection_tpu_torch.export import export_detector, load_exported

    det = Detector(name, device="cuda", input_size=64, rng_seed=0, **kw)
    path = str(tmp_path / f"{name}.npz")
    export_detector(det, path, batch_size=2)
    return det, load_exported(path)


@pytest.mark.parametrize("name,want", [
    ("yolov3", {"nms_keep": 1, "conv_epilogue": 75}),
    ("fcos", {"nms_keep": 1, "bias_gn_relu": 40, "gather_rows": 1,
              "fused_bottleneck": 6, "conv_epilogue": 34}),
])
def test_exported_equals_live_and_launches(cuda, tmp_path, name, want):
    """The exported bf16 program on the card answers bit for bit as the
    live Detector and launches exactly its kernels, through the
    `mydet::` ops the metadata lists."""
    det, served = export_pair(name, tmp_path, conf_thres=0.005)
    assert served.meta["platforms"] == ["cuda"]
    assert served.meta["custom_ops"] == sorted(f"mydet::{k}" for k in want)
    canvases = np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3),
                                                np.uint8)
    live = det._run_batch(canvases, 0.005, det.cfg.nms_iou, 2)
    kernels.reset_launches()
    got = served._run(canvases, 0.005)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    assert launches == {k: want.get(k, 0) for k in launches}
    for k in live:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
    assert live["valid"].any()


def test_flop_count_same_with_and_without_kernels(cuda):
    """fcos at 64 float32: FlopCounterMode reads the fused bottleneck's
    formula in place of the unfused convs, to the FLOP."""
    from mydetection_tpu_torch.summary import summarize

    with_k = summarize("fcos", input_size=64, device="cuda")
    plain = summarize("fcos", input_size=64, device="cuda", use_pallas=False)
    cpu = summarize("fcos", input_size=64, device="cpu")
    assert with_k["gflops_per_image"] == plain["gflops_per_image"] \
        == cpu["gflops_per_image"] > 0


def test_plain_artifact_moves_to_the_card(cuda, tmp_path):
    """An artifact exported on the CPU with use_pallas=False (the CLI's
    --oracle-nms) may be loaded on the card: its program answers as a
    `use_pallas=False` Detector on the card does, bit for bit, and
    launches no kernel. Exported without it, the load refuses."""
    from mydetection_tpu_torch.export import export_detector, load_exported

    kw = dict(input_size=64, rng_seed=0, pre_nms=64)
    cpu = Detector("yolov3", device="cpu", use_pallas=False, **kw)
    path = str(tmp_path / "cpu.npz")
    export_detector(cpu, path, batch_size=2)
    served = load_exported(path, device="cuda")
    assert served.meta["platforms"] == ["cpu"] and served.device.type == "cuda"
    assert served.meta["use_pallas"] is False
    cpu.use_pallas = True       # the same trace, as the kernels' route
    kernel_route = str(tmp_path / "kernel_route.npz")
    export_detector(cpu, kernel_route, batch_size=2)
    with pytest.raises(ValueError, match="without use_pallas=False"):
        load_exported(kernel_route, device="cuda")
    plain = Detector("yolov3", device="cuda", use_pallas=False, **kw)
    # the artifact keeps the CPU's NCHW weights; so must the reference,
    # or cuDNN runs another layout
    plain.model.to(memory_format=torch.contiguous_format)
    canvases = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 3),
                                                np.uint8)
    want = plain._run_batch(canvases, 0.3, plain.cfg.nms_iou, 2)
    kernels.reset_launches()
    got = served._run(canvases, 0.3)
    torch.cuda.synchronize()
    assert not any(fn.launches for fn in kernels.KERNELS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
