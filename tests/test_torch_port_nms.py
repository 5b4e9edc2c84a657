"""Port parity of the NMS slice: the plain keep-mask and the single-label
and dense multi-label postprocess against the JAX package (the CUDA kernel's legs are in
test_torch_port_cuda.py).

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

from chip_smoke import nms_cases  # noqa: E402
from mydetection_tpu.ops import nms as jnms  # noqa: E402
from mydetection_tpu.ops.pallas.nms_kernel import nms_pallas  # noqa: E402
from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain  # noqa: E402
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
