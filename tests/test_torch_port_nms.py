"""Port parity of the NMS slice: the plain keep-mask and the single-label
and dense multi-label postprocess against the JAX package (the CUDA kernel's legs are in
test_torch_port_cuda.py); the greedy kernels' launch plan
(`kernels.nms.nms_plan`) at the paths' shapes, and their two-phase
algorithm emulated step by step against the plain versions.

The hard keep-mask cases come from `chip_smoke.nms_cases`, the same
generator the chip run feeds the kernel: random sets with holes,
duplicates, tied runs, pairs within 1 ulp of iou_thres, an all-padding
image, mixed classes through the float32 class offset.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import (  # noqa: E402
    OLD_LARGEST_NMS_K,
    OLD_LARGEST_ROTATED_K,
    nms_cases,
)
from mydetection_tpu.ops import nms as jnms  # noqa: E402
from mydetection_tpu.ops.pallas.nms_kernel import nms_pallas  # noqa: E402
from mydetection_tpu_torch.kernels import nms as knms  # noqa: E402
from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain  # noqa: E402
from mydetection_tpu_torch.kernels.rotated_nms import (  # noqa: E402
    nms_from_iou_keep_plain,
)
from mydetection_tpu_torch.ops.boxes import pairwise_iou  # noqa: E402
from mydetection_tpu_torch.ops import nms as tnms  # noqa: E402

THR = 0.45
KINDS = ["random", "duplicates", "tied_runs", "near_threshold",
         "all_padding", "mixed_classes"]


@pytest.fixture(scope="module")
def cases():
    boxes, valid = nms_cases(np.random.RandomState(0), len(KINDS), 256)
    keep = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                          THR).numpy()
    return boxes, valid, keep


def _scores(valid):
    return np.where(valid, np.float32(1.0), np.float32(jnms.NEG_INF))


@pytest.mark.parametrize("kind", range(len(KINDS)), ids=KINDS)
def test_plain_keep_equals_jax_oracle_op_by_op(cases, kind):
    """`nms_padded_impl` evaluated op by op (strict float32 IoU)."""
    boxes, valid, keep = cases
    with jax.disable_jit():
        ref = jnms.nms_padded_impl(jnp.asarray(boxes[kind]),
                                   jnp.asarray(_scores(valid[kind])),
                                   iou_thres=THR, block=128)
    np.testing.assert_array_equal(keep[kind], np.asarray(ref))


@pytest.mark.parametrize("kind", range(len(KINDS)), ids=KINDS)
def test_plain_keep_equals_pallas_interpret(cases, kind):
    boxes, valid, keep = cases
    ref = nms_pallas(jnp.asarray(boxes[kind]), jnp.asarray(_scores(valid[kind])),
                     iou_thres=THR, block=128, interpret=True)
    np.testing.assert_array_equal(keep[kind], np.asarray(ref))


@pytest.mark.parametrize("kind", [k for k in range(len(KINDS))
                                  if KINDS[k] != "near_threshold"],
                         ids=[k for k in KINDS if k != "near_threshold"])
def test_plain_keep_equals_jitted_jax_oracle(cases, kind):
    """The jitted oracle too, except on the 1-ulp pairs: XLA:CPU's jit
    contracts the union's area product into an FMA, which rounds those
    IoUs differently (ROADMAP Queue C)."""
    boxes, valid, keep = cases
    ref = jnms.nms_padded(jnp.asarray(boxes[kind]),
                          jnp.asarray(_scores(valid[kind])),
                          iou_thres=THR, block=128)
    np.testing.assert_array_equal(keep[kind], np.asarray(ref))


@pytest.mark.parametrize("block", [64, 128, 256])
def test_plain_keep_does_not_depend_on_block(cases, block):
    boxes, valid, keep = cases
    got = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                         THR, block=block)
    np.testing.assert_array_equal(got.numpy(), keep)


def test_nms_keep_takes_plain_version_on_cpu(cases):
    boxes, valid, keep = cases
    before = nms_keep.launches
    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), THR)
    np.testing.assert_array_equal(got.numpy(), keep)
    assert nms_keep.launches == before  # nothing launched


def test_nms_keep_rejects_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms_keep(torch.zeros(1, 8, 4, device="meta"),
                 torch.zeros(1, 8, dtype=torch.bool, device="meta"), THR)


# ---------------------------------------------------------------------------
# single-label postprocess vs postprocess_impl(multi_label=False)
# ---------------------------------------------------------------------------

def _dense(seed, b, n, tied):
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, 416, (b, n, 2))
    wh = rng.uniform(4, 160, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if tied:  # a few distinct values: top-k and NMS order by index
        scores = np.round(scores * 4) / 4
    classes = rng.randint(0, 5, (b, n)).astype(np.int32)
    conf = rng.uniform(0.05, 0.5, b).astype(np.float32)
    return boxes, scores.astype(np.float32), classes, conf


@pytest.mark.parametrize("n,tied", [(300, False), (300, True),
                                    (1500, False), (1500, True)],
                         ids=["pad-random", "pad-tied", "topk-random",
                              "topk-tied"])
def test_postprocess_matches_jax(n, tied):
    """n = 300 < pre_nms pads with NEG_INF rows; n = 1500 takes top-k."""
    pre_nms, max_dets = 512, 100
    boxes, scores, classes, conf = _dense(n + tied, 3, n, tied)
    got = tnms.postprocess(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(classes),
                           conf_thres=torch.from_numpy(conf), iou_thres=THR,
                           pre_nms=pre_nms, max_dets=max_dets)
    for i in range(len(boxes)):
        ref = jnms.postprocess(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               classes=jnp.asarray(classes[i]),
                               conf_thres=conf[i], iou_thres=THR,
                               pre_nms=pre_nms, max_dets=max_dets,
                               multi_label=False, approx_topk=False)
        assert int(np.asarray(ref["valid"]).sum()) > 0
        for key in ("boxes", "scores", "classes", "valid"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)


def test_postprocess_multi_label_names_later_slice():
    """The dense (B, N, C) scores branch, which the RetinaNet slice
    brought, on _dense's boxes with 4 classes of scores: multi-label
    bit-equal to `postprocess_impl` (multi_label=True). The same case
    passed as (B, N) scores without classes raises."""
    boxes, scores, _, conf = _dense(7, 2, 600, False)
    rng = np.random.RandomState(7)
    dense = (scores[..., None] * rng.uniform(0, 1, (2, 600, 4))).astype(
        np.float32)
    got = tnms.postprocess(torch.from_numpy(boxes), torch.from_numpy(dense),
                           conf_thres=torch.from_numpy(conf), iou_thres=THR,
                           pre_nms=512, max_dets=100, multi_label=True)
    for i in range(len(boxes)):
        ref = jnms.postprocess(jnp.asarray(boxes[i]), jnp.asarray(dense[i]),
                               conf_thres=conf[i], iou_thres=THR,
                               pre_nms=512, max_dets=100, multi_label=True,
                               approx_topk=False)
        assert int(np.asarray(ref["valid"]).sum()) > 0
        for key in ("boxes", "scores", "classes", "valid"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
    with pytest.raises(ValueError, match="require classes"):
        tnms.postprocess(torch.from_numpy(boxes), torch.from_numpy(scores),
                         conf_thres=0.1, iou_thres=THR)


def test_top_k_breaks_ties_toward_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    vals, idx = tnms.top_k(x, 4)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()[0]), 4)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(ref_vals))


# ---------------------------------------------------------------------------
# the greedy kernels' launch plan and their algorithm, emulated on the CPU
# ---------------------------------------------------------------------------

# (B, K) the detect paths launch: detect_one and chip_smoke's batch 32 (and
# batches between), at the registered pre_nms (1024; rapid 512), and the
# banded sizes the card tests take
PATH_BATCHES = [1, 2, 8, 12, 16, 32, 64]
PATH_KS = [512, 1024]
H100_SMS = 132  # an H100 SXM's SMs; an H100 PCIe has 114


@pytest.mark.parametrize("sms", [H100_SMS, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("box_floats", [knms.BOX_FLOATS, 0],
                         ids=["boxes", "iou_matrix"])
@pytest.mark.parametrize("b", PATH_BATCHES)
def test_plan_at_the_paths_shapes(b, box_floats, sms):
    """On chip at the paths' K, a power-of-two cluster of at most 16
    blocks that keeps every block to MIN_ROWS rows and the grid to
    BLOCKS_PER_SM blocks an SM of the card where it can, the layout
    within a block's shared memory."""
    for k in PATH_KS:
        plan = knms.nms_plan(b, k, sms, box_floats=box_floats)
        assert plan.on_chip and plan.scratch == 0
        n = plan.cluster
        assert n & (n - 1) == 0 and 1 <= n <= knms.MAX_CLUSTER
        assert b * n <= knms.BLOCKS_PER_SM * sms or n == 1
        assert plan.rows == -(-k // n) and (plan.rows >= knms.MIN_ROWS
                                            or n == 1)
        grown = 2 * n
        assert (grown > knms.MAX_CLUSTER
                or b * grown > knms.BLOCKS_PER_SM * sms
                or -(-k // grown) < knms.MIN_ROWS)
        assert plan.smem == knms.smem_bytes(k, box_floats, 0) \
            <= knms.SMEM_LIMIT


@pytest.mark.parametrize("box_floats,old_largest",
                         [(knms.BOX_FLOATS, OLD_LARGEST_NMS_K),
                          (0, OLD_LARGEST_ROTATED_K)],
                         ids=["boxes", "iou_matrix"])
def test_plan_takes_every_k_the_old_kernels_took(box_floats, old_largest):
    """Every K up to the largest the one-block-an-image kernels accepted
    (21 bytes a box; a K x ceil(K/32) word mask) gets a plan: on chip up
    to the packed triangle's limit, banded above it, with at least two
    ring stages that fit; 2048 is banded for both kernels."""
    for k in sorted({1, 31, 32, 33, 200, 1024, 1728, 1729, 1888, 1889, 2048,
                     old_largest}):
        if k > old_largest and k != 2048:
            continue
        plan = knms.nms_plan(12, k, H100_SMS, box_floats=box_floats)
        fits = knms.smem_bytes(k, box_floats, 0) <= knms.SMEM_LIMIT
        assert plan.on_chip == fits
        assert plan.smem <= knms.SMEM_LIMIT
        if not plan.on_chip:
            words = -(-k // 32)
            assert 2 <= plan.stages <= knms.MAX_STAGES
            assert plan.scratch == knms.block_offset(words, words)
    assert not knms.nms_plan(1, 2048, H100_SMS,
                             box_floats=box_floats).on_chip


@pytest.mark.parametrize("box_floats,limit", [(knms.BOX_FLOATS, 11360),
                                              (0, 27680)],
                         ids=["boxes", "iou_matrix"])
def test_plan_refuses_past_its_limit(box_floats, limit):
    assert knms.nms_plan(1, limit, H100_SMS, box_floats=box_floats).smem \
        <= knms.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        knms.nms_plan(1, limit + 1, H100_SMS, box_floats=box_floats)


def test_packed_triangle_offsets():
    """Word block q starts where the blocks before it end, each 32 rows
    of (W - q) | 1 words: an odd row stride."""
    for words in range(1, 70):
        at = 0
        for q in range(words + 1):
            assert knms.block_offset(q, words) == at
            if q < words:
                assert knms.block_len(q, words) % 2 == 1
                assert knms.block_len(q, words) >= words - q
                at += 32 * knms.block_len(q, words)


def _resolve_word(alive: int, t: list[int]) -> int:
    """common.py:22's fixpoint on one word's 32 rows."""
    keep = alive
    while True:
        sup = 0
        for c in range(32):
            if keep >> c & 1:
                sup |= t[c]
        nxt = alive & ~sup
        if nxt == keep:
            return keep
        keep = nxt


def emulate_kernel(sup: np.ndarray, valid: np.ndarray, *, pull: bool,
                   rng) -> np.ndarray:
    """csrc/greedy_nms.cuh step by step on one image: sup (K, K) bool
    (box i suppresses box j), valid (K,). The packed triangle starts as
    noise, as shared memory and the scratch do; the mask phase writes
    the valid rows' words up to the last valid box; the resolve reads a
    row only once it is kept: on chip (`pull`) word q's removed bits are
    the OR of word q at each kept row's listed address plus q, banded
    each kept row's later words are ORed into `removed`."""
    k = len(valid)
    words = -(-k // 32)
    n_valid = int(np.flatnonzero(valid)[-1]) + 1 if valid.any() else 0
    last = (n_valid - 1) >> 5
    tri = [int(v) for v in rng.randint(0, 2**32, knms.block_offset(words,
                                                                   words),
                                       dtype=np.uint64)]
    cols = np.arange(32 * words)
    pad = np.zeros(32 * words, bool)
    for i in range(n_valid):
        if not valid[i]:
            continue
        q = i >> 5
        start = knms.block_offset(q, words) + (i & 31) * knms.block_len(q,
                                                                       words)
        row = pad.copy()
        row[:k] = sup[i] & valid & (cols[:k] > i)
        for w in range(q, last + 1):
            tri[start + w - q] = int(sum(1 << c for c in range(32)
                                         if row[32 * w + c]))
    vbits = [int(sum(1 << c for c in range(32)
                     if 32 * w + c < k and valid[32 * w + c]))
             for w in range(words)]
    removed, kept, listed = [0] * words, [0] * words, []
    for q in range(last + 1):
        blk, length = knms.block_offset(q, words), knms.block_len(q, words)
        if pull:
            removed[q] = 0
            for a in listed:
                removed[q] |= tri[a + q]
        alive = vbits[q] & ~removed[q]
        if alive:
            kb = _resolve_word(alive, [tri[blk + c * length]
                                       for c in range(32)])
            for c in range(32):
                if not kb >> c & 1:
                    continue
                listed.append(blk + c * length - q)
                for w in range(q + 1, last + 1):
                    if not pull:
                        removed[w] |= tri[blk + c * length + w - q]
            kept[q] = kb
    return np.array([j < n_valid and bool(kept[j >> 5] >> (j & 31) & 1)
                     for j in range(k)])


@pytest.mark.parametrize("pull", [True, False], ids=["on_chip", "banded"])
@pytest.mark.parametrize("kind", range(len(KINDS)), ids=KINDS)
def test_kernel_algorithm_equals_plain(kind, pull):
    """The two-phase design (packed triangle, word-by-word resolve by
    the fixpoint, removed bits pulled or pushed) on
    chip_smoke's hard cases at K = 200, a partial last word, against
    `nms_keep_plain`."""
    boxes, valid = nms_cases(np.random.RandomState(1), len(KINDS), 200)
    b, v = torch.from_numpy(boxes[kind:kind + 1]), torch.from_numpy(
        valid[kind:kind + 1])
    sup = (pairwise_iou(b, b)[0] > np.float32(THR)).numpy()
    got = emulate_kernel(sup, valid[kind], pull=pull,
                         rng=np.random.RandomState(kind))
    np.testing.assert_array_equal(got, nms_keep_plain(b, v, THR)[0].numpy())


@pytest.mark.parametrize("pull", [True, False], ids=["on_chip", "banded"])
def test_kernel_algorithm_reads_earlier_row_later_column(pull):
    """An asymmetric matrix with NaN entries, as the rotated suppress
    reads it (iou[earlier, later] > thr), against its plain version."""
    rng = np.random.RandomState(4)
    k = 96
    iou = rng.uniform(0, 1, (1, k, k)).astype(np.float32)
    iou[0, rng.randint(0, k, 40), rng.randint(0, k, 40)] = np.nan
    valid = rng.uniform(size=(1, k)) < 0.8
    valid[0, 90:] = False
    sup = iou[0] > np.float32(THR)
    got = emulate_kernel(sup, valid[0], pull=pull, rng=rng)
    ref = nms_from_iou_keep_plain(torch.from_numpy(iou),
                                  torch.from_numpy(valid), THR)
    np.testing.assert_array_equal(got, ref[0].numpy())


def _above_without_division(inter, u, thr):
    """csrc/nms.cu's iou_above after the float32 intersection and union,
    in numpy: RN(inter / u) > thr as inter > m * u in float64, m the
    midpoint of thr and the next float up, a tie going up where thr's
    last bit is odd; inf / inf (NaN) never."""
    nxt = np.nextafter(thr, np.float32(np.inf))
    m = (thr.astype(np.float64) + nxt.astype(np.float64)) / 2
    lhs, rhs = inter.astype(np.float64), m * u.astype(np.float64)
    odd = (thr.view(np.uint32) & 1).astype(bool)
    finite = ~(np.isinf(inter) & np.isinf(u))
    with np.errstate(invalid="ignore"):
        return finite & ((lhs > rhs) | ((lhs == rhs) & odd))


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.3, 0.7, 0.999, 0.0, -0.5,
                                 1e-30, 1.4e-45])
def test_iou_test_without_division_is_exact(thr):
    """The kernel's division-free test equals float32 division then
    compare on quotients within 3 ulps of thr, on zero, infinite and NaN
    intersections and unions, and on exact ties (a subnormal thr and a
    power-of-two union)."""
    rng = np.random.RandomState(int(abs(thr) * 1e3) + 1)
    n = 200_000
    u = rng.uniform(1e-3, 1e5, n).astype(np.float32)
    t = np.full(n, thr, np.float32)
    inter = (t.astype(np.float64) * u).astype(np.float32)
    steps = rng.randint(-3, 4, n)
    for s in range(3):
        inter = np.where(steps > s, np.nextafter(inter, np.float32(np.inf)),
                         inter)
        inter = np.where(steps < -s, np.nextafter(inter, np.float32(-np.inf)),
                         inter)
    inter = np.abs(inter)
    special = np.array([0.0, np.inf, np.nan, 1.0, 0.0, np.inf], np.float32)
    su = np.array([1e-9, 1.0, 1.0, np.inf, np.inf, np.inf], np.float32)
    inter, u = np.concatenate([inter, special]), np.concatenate([u, su])
    nxt = np.nextafter(np.float32(thr), np.float32(np.inf))
    mid = (np.float64(thr) + np.float64(nxt)) / 2
    for e in range(60, 127):  # ties: inter == mid * u exactly
        tie = np.float32(mid * 2.0 ** e)
        if np.isfinite(tie) and np.float64(tie) == mid * 2.0 ** e:
            inter = np.append(inter, tie)
            u = np.append(u, np.float32(2.0 ** e))
    t = np.full(len(u), thr, np.float32)
    with np.errstate(all="ignore"):
        ref = (inter / u) > t
    np.testing.assert_array_equal(_above_without_division(inter, u, t), ref)
