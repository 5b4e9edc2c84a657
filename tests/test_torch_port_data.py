"""The port's host data layer against the JAX package's, on the CPU:
augmentation bit for bit for the same RandomState, the COCO and
fisheye datasets item for item (error cases included), the ordered
thread pool, `StreamingPipeline` and `TrainLoader` batches bit for bit
(two epochs, augmentation and multi-scale on), and the port's own
native decoder (`mydetection_tpu_torch.native`) against JAX's PIL
letterbox within `tests/test_native.py`'s gates, with its CPU-keyed
build cache.

The JAX pipeline always runs with `native=False`: these tests never
build or load the JAX package's native library.
"""

import dataclasses
import io
import json
import threading
import time

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from mydetection_tpu.data import coco as jcoco  # noqa: E402
from mydetection_tpu.data import fisheye as jfisheye  # noqa: E402
from mydetection_tpu.data import loader as jloader  # noqa: E402
from mydetection_tpu.data import transforms as jtf  # noqa: E402
from mydetection_tpu.utils.image_ops import letterbox_np as j_letterbox_np  # noqa: E402

from mydetection_tpu_torch import native  # noqa: E402
from mydetection_tpu_torch.data import coco as pcoco  # noqa: E402
from mydetection_tpu_torch.data import fisheye as pfisheye  # noqa: E402
from mydetection_tpu_torch.data import loader as ploader  # noqa: E402
from mydetection_tpu_torch.data import transforms as ptf  # noqa: E402


def write_coco(root, n=6, seed=0):
    """`tests/test_data.py`'s synthetic set: n noise JPEGs of 80–200 px,
    0–3 boxes each in categories {1, 3, 7}."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n):
        w, h = int(rng.randint(80, 200)), int(rng.randint(80, 200))
        arr = rng.randint(0, 255, (h, w, 3), np.uint8)
        Image.fromarray(arr).save(root / f"img{i}.jpg")
        images.append({"id": i, "file_name": f"img{i}.jpg",
                       "width": w, "height": h})
        for _ in range(int(rng.randint(0, 4))):
            bw, bh = float(rng.uniform(10, 30)), float(rng.uniform(10, 30))
            x = float(rng.uniform(0, w - bw))
            y = float(rng.uniform(0, h - bh))
            annotations.append({
                "id": len(annotations), "image_id": i,
                "category_id": int(rng.choice([1, 3, 7])),
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
            })
    gt = {"images": images, "annotations": annotations,
          "categories": [{"id": c, "name": f"c{c}"} for c in (1, 3, 7)]}
    with open(root / "ann.json", "w") as fh:
        json.dump(gt, fh)
    return gt


def rotated_gt(gt, deg):
    gt = json.loads(json.dumps(gt))
    for ann in gt["annotations"]:
        bb = ann["bbox"]
        ann["bbox"] = [bb[0] + bb[2] / 2, bb[1] + bb[3] / 2, bb[2], bb[3],
                       float(deg)]
    return gt


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_coco")
    gt = write_coco(root)
    return root, gt


def assert_items_equal(a: dict, b: dict):
    assert set(a) == set(b)
    assert a["image_id"] == b["image_id"]
    for k in ("image", "boxes", "classes"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


# -- transforms ----------------------------------------------------------------

def _image_and_boxes(seed, cols):
    rng = np.random.RandomState(seed)
    h, w = int(rng.randint(40, 90)), int(rng.randint(40, 90))
    img = rng.randint(0, 255, (h, w, 3), np.uint8)
    n = int(rng.randint(1, 6))
    boxes = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n),
                      rng.uniform(4, 20, n), rng.uniform(4, 20, n)], 1)
    if cols == 5:
        boxes = np.concatenate([boxes, rng.uniform(-1.5, 1.5, (n, 1))], 1)
    return img, boxes.astype(np.float32), rng.randint(0, 5, n).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cols", [4, 5])
def test_flips_and_rotate_bit_equal(seed, cols):
    img, boxes, _ = _image_and_boxes(seed, cols)
    for fn in ("hflip", "vflip"):
        ji, jb = getattr(jtf, fn)(img, boxes)
        pi, pb = getattr(ptf, fn)(img, boxes)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pb, jb)
    for deg in (37.5, 90.0, 211.0):
        for expand in (False, True):
            j = jtf.rotate(img, boxes, deg, expand=expand)
            p = ptf.rotate(img, boxes, deg, expand=expand)
            for x, y in zip(p, j):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(3))
def test_hsv_jitter_bit_equal(seed):
    img, _, _ = _image_and_boxes(seed, 4)
    np.testing.assert_array_equal(
        ptf.hsv_jitter(img, np.random.RandomState(seed)),
        jtf.hsv_jitter(img, np.random.RandomState(seed)))


@pytest.mark.parametrize("rotated, rotate_prob", [(False, 0.0), (False, 0.7),
                                                  (True, 0.5), (True, 1.0)])
def test_random_augment_bit_equal(rotated, rotate_prob):
    for seed in range(6):
        img, boxes, cls = _image_and_boxes(seed, 5 if rotated else 4)
        j = jtf.random_augment(img, boxes, np.random.RandomState(seed),
                               rotated=rotated, rotate_prob=rotate_prob,
                               classes=cls)
        p = ptf.random_augment(img, boxes, np.random.RandomState(seed),
                               rotated=rotated, rotate_prob=rotate_prob,
                               classes=cls)
        for x, y in zip(p, j):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="classes"):
        ptf.random_augment(img, boxes, np.random.RandomState(0),
                           rotated=True, rotate_prob=1.0, classes=None)


# -- datasets ------------------------------------------------------------------

@pytest.mark.parametrize("rotated", [False, True])
def test_coco_dataset_items_equal(coco_dir, rotated):
    root, gt = coco_dir
    ann = rotated_gt(gt, 45.0) if rotated else str(root / "ann.json")
    for skip_empty in (False, True):
        j = jcoco.CocoDataset(ann, str(root), rotated=rotated,
                              skip_empty=skip_empty)
        p = pcoco.CocoDataset(ann, str(root), rotated=rotated,
                              skip_empty=skip_empty)
        assert p.ids == j.ids and p.num_classes == j.num_classes == 3
        assert p.cat_to_contig == j.cat_to_contig == {1: 0, 3: 1, 7: 2}
        assert p.contig_to_cat == j.contig_to_cat
        for i in range(len(j)):
            assert_items_equal(p[i], j[i])
    boxes = np.array([[100.0, 50, 40, 20], [3, 4, 5, 6]], np.float32)
    np.testing.assert_array_equal(pcoco.letterbox_labels(boxes, 0.5, 10, 20),
                                  jcoco.letterbox_labels(boxes, 0.5, 10, 20))


def test_coco_unknown_category_and_crowd(coco_dir):
    root, gt = coco_dir
    gt = json.loads(json.dumps(gt))
    gt["annotations"][0]["category_id"] = 9999
    gt["annotations"][1]["iscrowd"] = 1
    j = jcoco.CocoDataset(gt, str(root))
    p = pcoco.CocoDataset(gt, str(root))
    bad = gt["annotations"][0]["image_id"]
    for ds in (j, p):
        with pytest.raises(ValueError, match="category_id=9999"):
            ds.load_labels(bad)
    for img_id in p.ids:
        if img_id != bad:
            for x, y in zip(p.load_labels(img_id), j.load_labels(img_id)):
                np.testing.assert_array_equal(x, y)


def test_fisheye_adapters_equal(coco_dir, tmp_path):
    root, gt = coco_dir
    rgt = rotated_gt(gt, 30.0)
    for name in ("cepdof", "mw_r"):
        j = getattr(jfisheye, name)(rgt, str(root))
        p = getattr(pfisheye, name)(rgt, str(root))
        assert p.rotated and j.rotated
        for i in range(len(j)):
            assert_items_equal(p[i], j[i])

    hb = tmp_path / "habbof"
    (hb / "annotations").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for stem in ("f000", "f001", "f002", "f003"):
        Image.fromarray(rng.randint(0, 255, (80, 100, 3), np.uint8)).save(
            hb / f"{stem}.jpg")
    (hb / "f000.txt").write_text("person 50 40 20 30 45\n30 20 10 12 -15\n")
    (hb / "annotations" / "f001.txt").write_text("0 512.5 200.25 55 110 12.5\n")
    (hb / "f002.txt").write_text("\n\n")
    j, p = jfisheye.HabbofDataset(str(hb)), pfisheye.HabbofDataset(str(hb))
    assert len(p) == len(j) == 4 and p.paths == j.paths
    for i in range(4):
        assert_items_equal(p[i], j[i])
    (hb / "f003.txt").write_text("garbage line\n")
    for ds in (j, p):
        with pytest.raises(ValueError, match="cx cy w h"):
            ds[3]

    noann = tmp_path / "noann"
    noann.mkdir()
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(noann / "a.jpg")
    for mod in (jfisheye, pfisheye):
        with pytest.raises(ValueError, match="no images"):
            mod.HabbofDataset(str(tmp_path / "empty-nowhere"))
        with pytest.raises(ValueError, match="no annotation"):
            mod.HabbofDataset(str(noann))
    assert pfisheye.habbof is pfisheye.HabbofDataset


# -- the thread pool -----------------------------------------------------------

def test_threadpool_order_and_error():
    def slow_square(i):
        time.sleep(0.001 * ((7 - i) % 5))  # adversarial scheduling
        return i * i

    for threads in (1, 4, 9):
        out = list(ploader._ThreadPool(slow_square, range(40),
                                       num_threads=threads, prefetch=2))
        assert out == [i * i for i in range(40)]

    def boom(i):
        if i == 3:
            raise ValueError("boom")
        return i

    with pytest.raises(ValueError, match="boom"):
        list(ploader._ThreadPool(boom, range(8), num_threads=2, prefetch=2))


def test_threadpool_released_on_abandoned_iterator():
    before = threading.active_count()
    pool = ploader._ThreadPool(lambda i: i * i, range(500), num_threads=3,
                               prefetch=1)
    it = iter(pool)
    assert next(it) == 0
    it.close()  # what a consumer's break/GC does to the generator
    for t in pool._threads:
        t.join(timeout=10)
    assert all(not t.is_alive() for t in pool._threads)
    assert threading.active_count() <= before


# -- the loaders ---------------------------------------------------------------

def test_loaders_default_to_cuda(coco_dir):
    root, _ = coco_dir
    paths = [str(root / "img0.jpg")]
    ds = pcoco.CocoDataset(str(root / "ann.json"), str(root))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ploader.StreamingPipeline(paths, input_size=64, native=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ploader.TrainLoader(ds, batch_size=2, sizes=[64])
    with pytest.raises(ValueError, match="dataset is empty"):
        ploader.TrainLoader([], batch_size=2, sizes=[64], device="cpu")


@pytest.mark.parametrize("batch, threads", [(4, 2), (5, 3)])
def test_streaming_pipeline_equals_jax(coco_dir, batch, threads):
    root, _ = coco_dir
    paths = [str(root / f"img{i}.jpg") for i in range(6)] * 2
    j = list(jloader.StreamingPipeline(paths, input_size=64, batch_size=batch,
                                       num_threads=threads, device_put=False,
                                       native=False))
    p = list(ploader.StreamingPipeline(paths, input_size=64, batch_size=batch,
                                       num_threads=threads, device="cpu",
                                       native=False))
    pn = list(ploader.StreamingPipeline(paths, input_size=64, batch_size=batch,
                                        num_threads=1, device_put=False,
                                        native=False))
    assert len(p) == len(j) == len(pn) == -(-len(paths) // batch)
    for (pc, pi, pp), (jc, ji, jp), (nc, _, _) in zip(p, j, pn):
        assert isinstance(pc, torch.Tensor) and pc.device.type == "cpu"
        assert pc.dtype == torch.uint8 and pc.shape == (batch, 64, 64, 3)
        np.testing.assert_array_equal(pc.numpy(), jc)
        np.testing.assert_array_equal(nc, jc)
        assert [dataclasses.astuple(x) for x in pi] \
            == [dataclasses.astuple(x) for x in ji]
        assert pp == jp


def _train_loader_epochs(mod, ds, **kw):
    put = {"device": "cpu"} if mod is ploader else {"device_put": False}
    loader = mod.TrainLoader(ds, max_gt=10, **put, **kw)
    it = iter(loader)
    # two epochs through the endless iterator, as the train CLI reads it
    n = len(list(loader.epoch(0)))
    return [next(it) for _ in range(2 * n)]


@pytest.mark.parametrize("rotated", [False, True])
def test_train_loader_equals_jax(coco_dir, rotated):
    root, gt = coco_dir
    ann = rotated_gt(gt, 20.0) if rotated else str(root / "ann.json")
    kw = dict(batch_size=2, sizes=[64, 96, 128], num_threads=3,
              rotated=rotated, rescale_every=1, seed=7)
    j = _train_loader_epochs(jloader, jcoco.CocoDataset(ann, str(root),
                                                        rotated=rotated), **kw)
    p = _train_loader_epochs(ploader, pcoco.CocoDataset(ann, str(root),
                                                        rotated=rotated), **kw)
    assert len(p) == len(j) == 6
    assert len({b[4] for b in p}) > 1  # multi-scale really switched
    for pb, jb in zip(p, j):
        assert isinstance(pb[0], torch.Tensor) and pb[0].dtype == torch.uint8
        np.testing.assert_array_equal(pb[0].numpy(), jb[0])
        for x, y in zip(pb[1:4], jb[1:4]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert pb[4] == jb[4]
    if rotated:  # the rotation augmentation fired
        assert any((np.abs(b[1][b[3]][:, 4] - np.radians(20.0)) > 1e-3).any()
                   for b in p)


def test_train_loader_smaller_than_a_batch_equals_jax(coco_dir):
    root, _ = coco_dir
    kw = dict(batch_size=16, sizes=[64], num_threads=2, augment=False, seed=1)
    j = list(jloader.TrainLoader(jcoco.CocoDataset(str(root / "ann.json"),
                                                   str(root)),
                                 device_put=False, **kw).epoch(0))
    p = list(ploader.TrainLoader(pcoco.CocoDataset(str(root / "ann.json"),
                                                   str(root)),
                                 device_put=False, **kw).epoch(0))
    assert len(p) == len(j) == 1
    assert isinstance(p[0][0], np.ndarray) and p[0][0].shape[0] == 16
    for x, y in zip(p[0][:4], j[0][:4]):
        np.testing.assert_array_equal(x, y)


# -- the native decoder --------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip(f"native build failed here: {native.build_error()}")
    return native


def _jpeg(img, quality=95):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_native_letterbox_within_2_lsb_of_pil(built):
    rng = np.random.RandomState(0)
    for shape in ((480, 640), (640, 480), (100, 300), (50, 40)):
        img = rng.randint(0, 255, (*shape, 3), np.uint8)
        c_pil, i_pil = j_letterbox_np(img, 128)
        c_nat, i_nat = built.letterbox_rgb(img, 128)
        assert c_nat.shape == (128, 128, 3)
        assert i_nat.ratio == pytest.approx(i_pil.ratio, rel=1e-6)
        assert (i_nat.pad_x, i_nat.pad_y) == (i_pil.pad_x, i_pil.pad_y)
        assert (i_nat.ori_w, i_nat.ori_h) == (i_pil.ori_w, i_pil.ori_h)
        diff = np.abs(c_pil.astype(int) - c_nat.astype(int))
        assert diff.max() <= 2 and diff.mean() < 0.5, shape
    with pytest.raises(ValueError, match="HWC"):
        built.letterbox_rgb(np.zeros((4, 4), np.uint8), 32)
    with pytest.raises(ValueError, match="empty"):
        built.letterbox_rgb(np.zeros((0, 4, 3), np.uint8), 32)


def test_native_jpeg_geometry_and_invalid(built):
    img = np.random.RandomState(1).randint(0, 255, (300, 500, 3), np.uint8)
    data = _jpeg(img)
    canvas, info = built.decode_letterbox_jpeg(data, 256)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    c_pil, i_pil = j_letterbox_np(pil, 256)
    assert (info.ori_w, info.ori_h) == (500, 300)
    assert info.ratio == pytest.approx(256 / 500, rel=1e-6)
    assert (info.pad_x, info.pad_y) == (i_pil.pad_x, i_pil.pad_y)
    assert (canvas[0] == 114).all() and (canvas[-1] == 114).all()
    diff = np.abs(canvas.astype(int) - c_pil.astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.5
    with pytest.raises(ValueError):
        built.decode_letterbox_jpeg(b"not a jpeg at all", 64)


@pytest.mark.parametrize("h, w", [(1200, 1600), (1201, 1603)])
def test_native_dct_prescale_geometry(built, h, w):
    img = np.random.RandomState(2).randint(0, 255, (h, w, 3), np.uint8)
    data = _jpeg(img, 90)
    canvas, info = built.decode_letterbox_jpeg(data, 128)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    c_pil, i_pil = j_letterbox_np(pil, 128)
    assert (info.ori_w, info.ori_h) == (w, h)
    assert info.ratio == pytest.approx(i_pil.ratio, rel=1e-6)
    assert (info.pad_x, info.pad_y) == (i_pil.pad_x, i_pil.pad_y)
    assert np.abs(canvas.astype(int) - c_pil.astype(int)).mean() < 6


def test_native_pipeline_falls_back_per_image(built, tmp_path):
    rng = np.random.RandomState(3)
    paths = []
    for i, fmt in enumerate(["JPEG", "PNG"]):
        p = tmp_path / f"img{i}.{fmt.lower()}"
        Image.fromarray(rng.randint(0, 255, (60, 90, 3), np.uint8)).save(
            p, format=fmt)
        paths.append(str(p))
    pipe = ploader.StreamingPipeline(paths, input_size=64, batch_size=2,
                                     num_threads=1, device="cpu", native=True)
    assert pipe.decoder == "native"
    [(canv, infos, _)] = list(pipe)
    assert canv.shape == (2, 64, 64, 3)
    assert infos[0].ori_w == 90 and infos[1].ori_w == 90
    c_pil, _ = j_letterbox_np(np.asarray(Image.open(paths[1]).convert("RGB")),
                              64)
    np.testing.assert_array_equal(canv[1].numpy(), c_pil)  # the PNG: PIL


def test_native_cache_key():
    cpu = native.cpu_signature("processor\t: 0\nmodel name\t: CPU A\n"
                               "flags\t\t: fpu sse avx2\n\nprocessor\t: 1\n"
                               "model name\t: CPU B\nflags\t\t: fpu\n")
    assert cpu == "CPU A\nfpu sse avx2"
    base = native.library_path(cpu=cpu)
    assert base.parent == native.BUILD_DIR
    assert base.name.startswith("libimagepipe-") and base.suffix == ".so"
    assert native.library_path(cpu=cpu) == base
    assert native.library_path(cpu="CPU A\nfpu sse") != base
    assert native.library_path(cpu="CPU C\nfpu sse avx2") != base
    assert native.library_path(cpu=cpu, source=b"// edited\n"
                               + native.SRC.read_bytes()) != base
    assert native.library_path(cpu=cpu,
                               flags=native.CXX_FLAGS + ("-g",)) != base
    assert native.library_path() == native.library_path(
        cpu=native.cpu_signature())


def test_native_concurrent_builds_leave_one_library(tmp_path):
    import ctypes

    out = native.library_path(tmp_path / "build" / "native")
    errors = []

    def build():
        try:
            native.build(out)
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert all(not t.is_alive() for t in threads)
    if errors:
        pytest.skip(f"native build failed here: {errors[0]}")
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    lib = ctypes.CDLL(str(out))
    assert lib.decode_letterbox_jpeg and lib.letterbox_rgb
