"""Port parity of the rotated ops: the Liang–Barsky rotated IoU, its
polygon oracle, the suppress keep-mask from an IoU matrix and the
rotated postprocess, against the JAX package on the CPU (the CUDA
kernel's legs are in test_torch_port_cuda.py).

IoU gates: the port evaluates the JAX order of operations, so given the
same cos/sin per box it equals the op-by-op JAX IoU bit for bit. With
its own cos/sin (torch's and XLA's differ in the last bit on some
angles) the gate is 1e-4 absolute: a 1-ulp angle moves a corner by
~1e-7 of the box size, and nearly parallel edges of jittered duplicates
turn that into up to 3.1e-5 of IoU (measured). Keep-masks are compared
bit for bit on one shared IoU matrix.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import person_boxes, rotated_cases  # noqa: E402
from mydetection_tpu.ops import rotated as JR  # noqa: E402
from mydetection_tpu.ops.nms import NEG_INF  # noqa: E402
from mydetection_tpu.ops.pallas.rotated_nms_kernel import (  # noqa: E402
    nms_from_iou_pallas,
)
from mydetection_tpu_torch.kernels.rotated_nms import (  # noqa: E402
    nms_from_iou_keep,
    nms_from_iou_keep_plain,
)
from mydetection_tpu_torch.ops import rotated as TR  # noqa: E402

THR = 0.45
IOU_ATOL = 1e-4
GOLDEN = "tests/golden/rapid_e2e.npz"


def _set(kind: str) -> np.ndarray:
    """(100, 5) float32 box sets of one kind, seeded (one size, so the
    op-by-op JAX side compiles each primitive once)."""
    rng = np.random.RandomState(len(kind))
    if kind == "person":
        return person_boxes(rng, 100)
    if kind == "duplicates":
        base = person_boxes(rng, 25)
        jit = rng.normal(0, 1, (4, 25, 5)) * [0.5, 0.5, 0.5, 0.5, 0.01]
        return (base[None] + jit).reshape(-1, 5).astype(np.float32)
    if kind == "offset_1e4":
        b = person_boxes(rng, 100, canvas=300.0)
        b[:, :2] += 1e4 - 150
        return b
    if kind == "degenerate":
        cases = np.array([
            [10, 10, 8, 4, 0.3], [10, 10, 8, 4, 0.3],        # identical
            [0, 0, 2, 2, 0.0], [2, 0, 2, 2, 0.0],            # touching
            [1, 0.5, 2, 1, 0.0], [2, 0.5, 2, 1, 0.0],        # shared edge
            [10, 10, 20, 20, 0.0], [10, 10, 4, 4, 0.5],      # nested
            [0, 0, 10, 2, 0.0], [0, 0, 2, 10, 0.0],          # cross
            [50, 50, 30, 10, 0.7], [50, 53, 30, 10, 0.7],    # parallel
            [50, 50, 30, 10, np.pi / 2], [50, 50, 30, 10, -np.pi / 2],
        ], np.float32)
        return np.concatenate([cases, person_boxes(rng, 86, canvas=60.0)])
    if kind == "golden_slivers":   # the saturated RAPiD golden's boxes
        return np.load(GOLDEN)["boxes_rot"].astype(np.float32)
    raise KeyError(kind)


KINDS = ["person", "duplicates", "offset_1e4", "degenerate", "golden_slivers"]


def _port_iou(boxes):
    t = torch.from_numpy(boxes)
    return TR.pairwise_rotated_iou(t, t).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_pairwise_iou_bit_equal_to_jax_on_shared_trig(kind):
    """The JAX op-by-op IoU fed the port's cos/sin equals the port's."""
    boxes = _set(kind)
    n = len(boxes)
    th = torch.from_numpy(boxes[:, 4])
    cos, sin = jnp.asarray(torch.cos(th).numpy()), jnp.asarray(torch.sin(th).numpy())
    jb = jnp.asarray(boxes)
    with jax.disable_jit():
        ref = JR.rotated_iou_impl(
            jnp.broadcast_to(jb[:, None], (n, n, 5)),
            jnp.broadcast_to(jb[None], (n, n, 5)),
            trig_a=(jnp.broadcast_to(cos[:, None], (n, n)),
                    jnp.broadcast_to(sin[:, None], (n, n))),
            trig_b=(jnp.broadcast_to(cos[None], (n, n)),
                    jnp.broadcast_to(sin[None], (n, n))))
    np.testing.assert_array_equal(_port_iou(boxes), np.asarray(ref))


@pytest.mark.parametrize("kind", KINDS)
def test_pairwise_iou_matches_jitted_jax(kind):
    """Each side with its own cos/sin, the JAX side jitted (XLA:CPU
    contracts into FMAs): within IOU_ATOL (module docstring)."""
    boxes = _set(kind)
    ref = np.asarray(JR.pairwise_rotated_iou(jnp.asarray(boxes),
                                             jnp.asarray(boxes)))
    got = _port_iou(boxes)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_ATOL)


def test_pairwise_iou_is_symmetric_and_batched():
    """Eager float32 without FMA contraction makes the port's matrix
    symmetric bit for bit (the jitted JAX one is not: ROADMAP Queue C);
    the batched call equals one call per image."""
    a, b = _set("person"), _set("duplicates")
    single = [_port_iou(x) for x in (a, b)]
    np.testing.assert_array_equal(single[0], single[0].T)
    batch = torch.from_numpy(np.stack([a, b]))
    got = TR.pairwise_rotated_iou(batch, batch).numpy()
    np.testing.assert_array_equal(got, np.stack(single))
    rect = TR.pairwise_rotated_iou(batch[:, :30], batch[:, 30:70])
    assert rect.shape == (2, 30, 40)
    np.testing.assert_array_equal(rect[1].numpy(), single[1][:30, 30:70])


def test_lb_area_matches_polygon_oracle():
    """The production area against the port's 24-candidate polygon
    oracle, as tests/test_rotated.py holds the JAX pair: within 0.5% of
    the smaller box at small and image-scale offsets, and exact on the
    boundary-degenerate cases."""
    rng = np.random.RandomState(11)
    n = 4000

    def sample(off):
        return torch.from_numpy(np.stack(
            [rng.uniform(0, 100, n) + off, rng.uniform(0, 100, n) + off,
             rng.uniform(5, 60, n), rng.uniform(5, 60, n),
             rng.uniform(-np.pi / 2, np.pi / 2, n)], -1).astype(np.float32))

    for off in (0.0, 900.0):
        a, b = sample(off), sample(off)
        poly = TR.rotated_intersection_area(a, b)
        lb = TR.rotated_intersection_area_lb(a, b)
        min_area = torch.minimum(a[:, 2] * a[:, 3], b[:, 2] * b[:, 3])
        assert float(((poly - lb).abs() / min_area).max()) < 0.005
    cases = [([10, 10, 8, 4, 0.3], [10, 10, 8, 4, 0.3], 32.0),
             ([0, 0, 2, 2, 0.0], [2, 0, 2, 2, 0.0], 0.0),
             ([1, 0.5, 2, 1, 0.0], [2, 0.5, 2, 1, 0.0], 1.0),
             ([0, 0, 2, 2, np.pi / 4], [0, 0, 2, 2, 0.0], 8 * (np.sqrt(2) - 1)),
             ([10, 10, 20, 20, 0.0], [10, 10, 4, 4, 0.5], 16.0),
             ([0, 0, 10, 2, 0.0], [0, 0, 2, 10, 0.0], 4.0)]
    for aa, bb, want in cases:
        a, b = torch.tensor(aa), torch.tensor(bb)
        assert float(TR.rotated_intersection_area_lb(a, b)) == \
            pytest.approx(want, abs=5e-3), (aa, bb)
        assert float(TR.rotated_intersection_area(a, b)) == \
            pytest.approx(want, abs=5e-3), (aa, bb)


def test_polygon_oracle_matches_jax():
    """The port's polygon oracle against the JAX one (stable argsort on
    both sides, the JAX one jitted) on 500 random pairs: within 1e-4
    relative and 1e-3 px² (cos/sin ulps, FMA contraction and the 24-term
    shoelace of crosses near 1e5 px² rounding in another order; measured
    4.7e-5)."""
    boxes = _set("person")
    rng = np.random.RandomState(3)
    i, j = rng.randint(0, len(boxes), (2, 500))
    ref = jax.jit(JR.rotated_intersection_area)(jnp.asarray(boxes[i]),
                                                jnp.asarray(boxes[j]))
    got = TR.rotated_intersection_area(torch.from_numpy(boxes[i]),
                                       torch.from_numpy(boxes[j]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


def test_rotated_iou_known_values():
    """tests/test_rotated.py's closed forms, through the port."""
    iou = TR.rotated_iou
    t = torch.tensor
    assert float(iou(t([0.0, 0, 20, 10, 0]), t([5.0, 0, 20, 10, 0]))) == \
        pytest.approx(150 / 250, abs=1e-5)
    assert float(iou(t([3.0, -2, 8, 4, 0.7]), t([3.0, -2, 8, 4, 0.7]))) == \
        pytest.approx(1.0, abs=1e-5)
    assert float(iou(t([0.0, 0, 4, 4, 0.3]), t([100.0, 100, 4, 4, 1.0]))) == 0.0
    assert float(iou(t([0.0, 0, 20, 4, 0]), t([0.0, 0, 20, 4, np.pi / 2]))) == \
        pytest.approx(16 / 144, abs=1e-5)


# ---------------------------------------------------------------------------
# keep-mask from a shared IoU matrix
# ---------------------------------------------------------------------------

K = 128


def _shared_cases():
    """(name, iou (K, K) float32 from the jitted JAX IoU, valid (K,))."""
    rng = np.random.RandomState(5)
    boxes = person_boxes(rng, K, canvas=400.0)
    base = np.asarray(JR.pairwise_rotated_iou(jnp.asarray(boxes),
                                              jnp.asarray(boxes)))
    upper = np.triu(np.ones((K, K), bool), 1)
    thr32 = np.float32(THR)
    near = np.array([np.nextafter(thr32, np.float32(-1)), thr32,
                     np.nextafter(thr32, np.float32(2))], np.float32)
    at_thr = base.copy()
    hit = upper & (rng.uniform(size=(K, K)) < 0.3)
    at_thr[hit] = near[rng.randint(0, 3, int(hit.sum()))]
    asym = np.where(upper, base, rng.uniform(0, 1, (K, K)).astype(np.float32))
    ones = np.ones(K, bool)
    few = np.zeros(K, bool)
    few[:23] = True
    holes = rng.uniform(size=K) < 0.8
    return [("jax_iou", base, ones), ("jax_iou_holes", base, holes),
            ("at_threshold", at_thr, ones), ("asymmetric", asym, ones),
            ("all_padding", base, np.zeros(K, bool)),
            ("fewer_than_a_block", base, few)]


SHARED = _shared_cases()


def _scores(valid):
    return jnp.asarray(np.where(valid, np.float32(1.0), np.float32(NEG_INF)))


def _lax_oracle(monkeypatch, iou, valid, block=64):
    """`rotated_nms_padded_impl(use_pallas=False)` on this IoU matrix."""
    monkeypatch.setattr(JR, "pairwise_rotated_iou_impl",
                        lambda a, b: jnp.asarray(iou))
    return np.asarray(JR.rotated_nms_padded_impl(
        jnp.zeros((len(valid), 5)), _scores(valid), iou_thres=THR,
        block=block))


@pytest.mark.parametrize("case", range(len(SHARED)),
                         ids=[c[0] for c in SHARED])
def test_plain_keep_equals_lax_and_pallas_oracles(monkeypatch, case):
    _, iou, valid = SHARED[case]
    got = nms_from_iou_keep_plain(torch.tensor(iou)[None],
                                  torch.from_numpy(valid)[None], THR)[0].numpy()
    np.testing.assert_array_equal(got, _lax_oracle(monkeypatch, iou, valid))
    pallas = nms_from_iou_pallas(jnp.asarray(iou), _scores(valid),
                                 iou_thres=THR, block=64, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    assert not (got & ~valid).any()


def test_plain_keep_reads_earlier_row_later_column():
    """On the asymmetric matrix the transpose gives another keep-set:
    the orientation is pinned, not an accident of symmetric inputs."""
    _, iou, valid = SHARED[3]
    iou_t = torch.from_numpy(iou)[None]
    v = torch.from_numpy(valid)[None]
    assert not torch.equal(nms_from_iou_keep_plain(iou_t, v, THR),
                           nms_from_iou_keep_plain(iou_t.transpose(1, 2), v,
                                                   THR))


def test_plain_keep_treats_nan_as_no_overlap(monkeypatch):
    """NaN entries never suppress, as in the lax oracle. (The Pallas
    kernel's one-hot contraction turns NaN·0 into NaN across a tile, so
    it is not held here; real IoUs are never NaN: the union is
    floored.)"""
    _, iou, valid = SHARED[0]
    rng = np.random.RandomState(9)
    nan = iou.copy()
    nan[rng.uniform(size=(K, K)) < 0.05] = np.nan
    got = nms_from_iou_keep_plain(torch.from_numpy(nan)[None],
                                  torch.from_numpy(valid)[None], THR)[0]
    np.testing.assert_array_equal(got.numpy(),
                                  _lax_oracle(monkeypatch, nan, valid))


@pytest.mark.parametrize("block", [32, 64, 128, 50])
def test_plain_keep_does_not_depend_on_block(block):
    """chip_smoke's hard cases at K = 200 (not a multiple of 32): every
    block size gives the same keep-set, ragged last block included."""
    iou, valid = rotated_cases(np.random.RandomState(1), 6, 200)
    ref = nms_from_iou_keep_plain(iou, valid, THR, block=64)
    got = nms_from_iou_keep_plain(iou, valid, THR, block=block)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert not ref[4].any() and ref.sum() > 0


def test_chip_smoke_cases_match_lax_oracle(monkeypatch):
    """The generator chip_smoke feeds the kernel, at K = 128: the plain
    keep-mask equals the lax oracle image by image on the port's
    matrices (asymmetric and near-threshold kinds included)."""
    iou, valid = rotated_cases(np.random.RandomState(2), 6, K)
    keep = nms_from_iou_keep_plain(iou, valid, THR).numpy()
    assert (iou[3] != iou[3].T).any()
    for i in range(6):
        np.testing.assert_array_equal(
            keep[i], _lax_oracle(monkeypatch, iou[i].numpy(), valid[i].numpy()))


def test_wrapper_takes_plain_version_on_cpu():
    iou, valid = rotated_cases(np.random.RandomState(4), 6, 64)
    before = nms_from_iou_keep.launches
    got = nms_from_iou_keep(iou, valid, THR)
    np.testing.assert_array_equal(
        got.numpy(), nms_from_iou_keep_plain(iou, valid, THR).numpy())
    assert nms_from_iou_keep.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms_from_iou_keep(torch.zeros(1, 8, 8, device="meta"),
                          torch.zeros(1, 8, dtype=torch.bool, device="meta"),
                          THR)


# ---------------------------------------------------------------------------
# rotated postprocess against rotated_postprocess_impl
# ---------------------------------------------------------------------------

def _dense(kind, b=3):
    rng = np.random.RandomState({"topk": 0, "padded": 1, "tied": 2}[kind])
    n = 252 if kind == "padded" else 700
    boxes = np.stack([person_boxes(rng, n, canvas=512.0) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if kind == "tied":
        scores[:] = np.float32(1.0)
    return boxes, scores


@pytest.mark.parametrize("kind", ["topk", "padded", "tied"])
def test_rotated_postprocess_matches_jax(kind):
    """N = 700 takes the top-512; N = 252 pads with NEG_INF rows at index
    0 (the input_size = 64 case); all-tied scores order by index.
    Per-image conf. Every output equal."""
    boxes, scores = _dense(kind)
    confs = np.array([0.1, 0.3, 0.6], np.float32)
    got = TR.rotated_postprocess(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 conf_thres=torch.from_numpy(confs),
                                 iou_thres=THR, pre_nms=512, max_dets=100)
    for i in range(len(boxes)):
        ref = JR.rotated_postprocess(jnp.asarray(boxes[i]),
                                     jnp.asarray(scores[i]),
                                     conf_thres=float(confs[i]), iou_thres=THR,
                                     pre_nms=512, max_dets=100, block=64,
                                     approx_topk=False)
        assert int(np.asarray(ref["valid"]).sum()) > 0
        assert got["classes"].dtype == torch.int32
        for key in ("valid", "classes", "scores", "boxes"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
