"""Weights in and out of the port against the JAX package, on the CPU:
darknet `.weights` files, torchvision-named state dicts, `.npz`
checkpoints (written by either package and read by the other, resumed
mid-training), and `Detector`'s format guards.

The darknet files of both packages are the same bytes for the same tree
and read back bit for bit. The torchvision state dicts are built here
as `tests/test_weight_import.py` builds them (no download), their conv
weights scaled by 1/sqrt(fan_in) and their running variances kept above
0.5 so a 50-layer forward stays finite; both packages' importers fill
the same template tree with the same bits, and the imported models'
forwards agree within 1e-4 of the largest |value|.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import (  # noqa: E402
    PARITY_LR,
    TRAIN_COSINE_GATE,
    TRAIN_L2_GATE,
    TRAIN_LOSS_RTOL,
    cosine,
    max_scaled,
    rel_l2,
    train_batch,
)
from mydetection_tpu import checkpoint as jckpt  # noqa: E402
from mydetection_tpu import training as jtraining  # noqa: E402
from mydetection_tpu import weight_import as jwi  # noqa: E402
from mydetection_tpu.api import Detector as JDetector  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch import checkpoint as tckpt  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch import weight_import as twi  # noqa: E402
from mydetection_tpu_torch.convert import (  # noqa: E402
    from_jax_params,
    model_tree,
    to_jax_opt,
)
from mydetection_tpu_torch.registry import forward_dense  # noqa: E402
from test_weight_import import (  # noqa: E402
    _conv_entry,
    _fake_fpn_state,
    _fake_torch_resnet_state,
)

SIZE, CLASSES = 64, 4


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def assert_trees_equal(got, ref) -> None:
    got, ref = _flat(got), _flat(ref)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def yolo_tree():
    """A full-width YOLOv3 tree with every leaf moved off its init (BN
    statistics included), as numpy."""
    key = jax.random.PRNGKey(3)
    params = jget_model("yolov3").init(key)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(key, x.shape, jnp.float32),
        params)
    return jwi.jax_to_numpy(params)


def _template(name: str, **cfg) -> dict:
    """The port model's JAX-named tree: what the port's importers fill."""
    return model_tree(registry.get_model(name, **cfg))


# ---------------------------------------------------------------------------
# darknet .weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone_only", [False, True])
def test_darknet_file_is_byte_equal_to_jax(tmp_path, yolo_tree, backbone_only):
    mine, theirs = tmp_path / "port.weights", tmp_path / "jax.weights"
    twi.save_darknet_weights(yolo_tree, str(mine), backbone_only=backbone_only)
    jwi.save_darknet_weights(yolo_tree, str(theirs),
                             backbone_only=backbone_only)
    assert mine.read_bytes() == theirs.read_bytes()


def test_darknet_roundtrip_is_bit_exact(tmp_path, yolo_tree):
    """A JAX-written yolov3.weights read into the port's template gives
    the tree back bit for bit, and the port's Detector takes the file."""
    path = str(tmp_path / "yolov3.weights")
    jwi.save_darknet_weights(yolo_tree, path)
    assert_trees_equal(twi.load_darknet_weights(_template("yolov3"), path),
                       yolo_tree)
    det = Detector("yolov3", weights_path=path, device="cpu")
    want = from_jax_params(_flat(yolo_tree))
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("name", ["yolov3", "rapid"])
def test_darknet_backbone_only_roundtrip(tmp_path, yolo_tree, name):
    """A darknet53.conv.74-style file fills the backbone bit for bit and
    leaves the head as the template had it, for yolov3 and rapid."""
    path = str(tmp_path / "darknet53.conv.74")
    jwi.save_darknet_weights(yolo_tree, path, backbone_only=True)
    template = _template(name)
    got = twi.load_darknet_backbone_weights(template, path)
    assert_trees_equal(got["backbone"], yolo_tree["backbone"])
    assert_trees_equal(got["head"], template["head"])


@pytest.mark.parametrize("case", ["trailing", "full_into_backbone", "short"])
def test_darknet_stream_of_the_wrong_length(tmp_path, yolo_tree, case):
    """A stream longer or shorter than the tree's convs is refused, as
    the JAX loader refuses it."""
    path = str(tmp_path / "w.weights")
    twi.save_darknet_weights(yolo_tree, path)
    load = twi.load_darknet_weights
    if case == "trailing":
        with open(path, "ab") as fh:
            np.zeros(7, np.float32).tofile(fh)
    elif case == "full_into_backbone":
        load = twi.load_darknet_backbone_weights
    else:
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-4])
    match = "exhausted" if case == "short" else "length mismatch"
    with pytest.raises(ValueError, match=match):
        load(_template("yolov3"), path)
    jload = getattr(jwi, load.__name__)
    with pytest.raises(ValueError, match=match):
        jload(yolo_tree, path)


# ---------------------------------------------------------------------------
# torchvision state dicts
# ---------------------------------------------------------------------------

def _sane(state: dict) -> dict:
    """Conv weights scaled by 1/sqrt(fan_in), running variances at least
    0.5: the fake state dict's values, in a range a deep forward keeps
    finite."""
    out = {}
    for k, v in state.items():
        if v.ndim == 4:
            v = v / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("running_var"):
            v = v + 0.5
        out[k] = v.astype(np.float32)
    return out


def _torchvision_state(name: str, tree: dict) -> dict:
    """A torchvision-named state dict for `tree`'s shapes: the ResNet body
    alone ("resnet"), or the whole retinanet / fcos detector."""
    rng = np.random.RandomState(11)
    if name == "resnet":
        return _sane(_fake_torch_resnet_state(tree))
    state = {"backbone.body." + k: v
             for k, v in _fake_torch_resnet_state(tree["backbone"]).items()}
    state.update(_fake_fpn_state(tree["fpn"], rng))
    head = tree["head"]
    if name == "retinanet":
        for ours, tv in (("cls", "classification_head"),
                         ("box", "regression_head")):
            for i in range(4):
                state.update(_conv_entry(rng, head[ours][f"conv{i}"],
                                         f"head.{tv}.conv.{i}.0"))
            final = "cls_logits" if ours == "cls" else "bbox_reg"
            state.update(_conv_entry(rng, head[ours]["out"],
                                     f"head.{tv}.{final}"))
        return _sane(state)
    for tower, tv in (("cls_tower", "classification_head"),
                      ("box_tower", "regression_head")):
        for i in range(4):
            state.update(_conv_entry(rng, head[tower][f"conv{i}"],
                                     f"head.{tv}.conv.{i}.0"))
            c = head[tower][f"gn{i}"]["scale"].shape[0]
            state[f"head.{tv}.conv.{i}.1.weight"] = rng.randn(c).astype(np.float32)
            state[f"head.{tv}.conv.{i}.1.bias"] = rng.randn(c).astype(np.float32)
    for key, node in (("classification_head.cls_logits", "cls_out"),
                      ("regression_head.bbox_reg", "box_out"),
                      ("regression_head.bbox_ctrness", "ctr_out")):
        state.update(_conv_entry(rng, head[node], f"head.{key}"))
    return _sane(state)


@pytest.fixture(scope="module", params=["retinanet", "fcos"])
def imported(request):
    """One detector's JAX init tree, a torchvision state dict for it, and
    both packages' imports of that dict into that tree."""
    name = request.param
    cfg = dict(num_classes=CLASSES, compute_dtype=jnp.float32,
               input_size=SIZE)
    if name == "fcos":
        cfg["ltrb_decode"] = "linear"
    jm = jget_model(name, **cfg)
    tree = jwi.jax_to_numpy(jm.init(jax.random.PRNGKey(0)))
    state = _torchvision_state(name, tree)
    importer = f"import_{name}_state_dict"
    return {"name": name, "cfg": cfg, "jmodel": jm, "state": state,
            "jax": getattr(jwi, importer)(tree, state),
            "port": getattr(twi, importer)(
                tckpt.unflatten_tree(_flat(tree)), state)}


def test_resnet_import_matches_jax():
    """The ResNet-50 body map fills the same bits, and the imported
    backbones give the same C3–C5."""
    from mydetection_tpu.models import resnet as jresnet
    from mydetection_tpu_torch.models.resnet import ResNet

    tree = jwi.jax_to_numpy(jresnet.init(jax.random.PRNGKey(0), depth=50))
    state = _torchvision_state("resnet", tree)
    got = twi.import_resnet_state_dict(tckpt.unflatten_tree(_flat(tree)), state)
    ref = jwi.import_resnet_state_dict(tree, state)
    assert_trees_equal(got, ref)
    x = np.random.RandomState(2).randn(1, SIZE, SIZE, 3).astype(np.float32)
    jfeats, _ = jresnet.apply(jax.tree_util.tree_map(jnp.asarray, ref),
                              jnp.asarray(x), depth=50)
    body = ResNet(50)
    body.load_state_dict(from_jax_params(_flat(got)), strict=True)
    with torch.no_grad():
        feats = body.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for f, r in zip(feats, jfeats):
        r = np.asarray(r)
        assert np.isfinite(r).all()
        assert max_scaled(f.permute(0, 2, 3, 1).numpy(), r) <= 1e-4


def test_detector_import_matches_jax(imported):
    """RetinaNet and FCOS: both importers fill the template with the same
    bits (FCOS's per-level scales, which torchvision lacks, keep it)."""
    assert_trees_equal(imported["port"], imported["jax"])
    if imported["name"] == "fcos":
        np.testing.assert_array_equal(imported["port"]["head"]["scales"],
                                      np.ones(5, np.float32))


def test_imported_detector_activations_match_jax(imported):
    """The imported detectors' dense outputs at 64² (boxes and class
    logits, and FCOS's centerness) within 1e-4 of the largest |value|."""
    x = np.random.RandomState(4).randint(0, 256, (1, SIZE, SIZE, 3), np.uint8)
    ref, _ = jax.jit(imported["jmodel"].forward_dense)(
        jax.tree_util.tree_map(jnp.asarray, imported["jax"]), jnp.asarray(x))
    cfg = {**imported["cfg"], "compute_dtype": torch.float32}
    model = registry.get_model(imported["name"], **cfg)
    model.load_state_dict(from_jax_params(_flat(imported["port"])),
                          strict=True)
    with torch.no_grad():
        got = forward_dense(model.eval(), torch.from_numpy(x))
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r, np.float32)
        assert np.isfinite(r).all(), k
        assert max_scaled(got[k].float().numpy(), r) <= 1e-4, k


def test_detector_loads_a_torch_checkpoint(tmp_path, imported):
    """`Detector(weights_path=".pt")` routes to the family's importer: the
    model's state is the port's import of the file."""
    path = str(tmp_path / "model.pth")
    torch.save({"model": {k: torch.from_numpy(v)
                          for k, v in imported["state"].items()}}, path)
    cfg = {**imported["cfg"], "compute_dtype": torch.float32}
    det = Detector(imported["name"], weights_path=path, device="cpu", **cfg)
    # the template is init_weights(0): FCOS's scales, which the file
    # lacks, keep it (1.0); everything else comes from the file
    want = from_jax_params(_flat(imported["port"]))
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_torch_checkpoint_loads_tensors_only(tmp_path):
    """A `.pt` holding a pickled module is refused (weights only)."""
    path = str(tmp_path / "module.pt")
    torch.save({"model": torch.nn.Linear(2, 2)}, path)
    with pytest.raises(Exception, match="Weights only load failed"):
        twi.load_torch_checkpoint(path)


# ---------------------------------------------------------------------------
# .npz checkpoints across the packages
# ---------------------------------------------------------------------------

def _yolo64_cfg(torch_side: bool) -> dict:
    return dict(num_classes=CLASSES, input_size=SIZE,
                compute_dtype=torch.float32 if torch_side else jnp.float32)


@pytest.fixture(scope="module")
def jax_yolo64():
    """yolov3 at 64², 4 classes: the JAX model and its seeded init."""
    jm = jget_model("yolov3", **_yolo64_cfg(False))
    return jm, jm.init(jax.random.PRNGKey(0))


def _port_step(flat: dict):
    model = registry.get_model("yolov3", **_yolo64_cfg(True))
    model.load_state_dict(from_jax_params(flat), strict=True)
    return ttraining.make_train_step(model, input_size=SIZE, device="cpu")


def test_port_checkpoint_loads_in_jax(tmp_path, jax_yolo64):
    """A checkpoint the port writes after a train step (params, velocity,
    step, extra) reads in JAX's `load_checkpoint` with the port's values,
    passes JAX's `check_params_compatible`, and drives JAX's Detector to
    the detections the port's Detector finds from the same file."""
    jm, params = jax_yolo64
    step = _port_step(_flat(params))
    data = train_batch(0, 2, SIZE, CLASSES)
    step(*data, PARITY_LR)
    path = str(tmp_path / "port.npz")
    step.save(path, step=1, extra={"epoch": 0})
    assert not (tmp_path / "port.npz.tmp").exists()

    ck = jckpt.load_checkpoint(path)
    assert ck["step"] == 1 and ck["format_version"] == jckpt.FORMAT_VERSION
    assert int(ck["extra"]["epoch"]) == 0
    state = step.model.state_dict()
    assert_trees_equal(ck["params"], model_tree(step.model))
    assert_trees_equal(ck["opt"], tckpt.unflatten_tree(
        to_jax_opt(step.velocity, state)))
    assert not any(v.any() for k, v in _flat(ck["opt"]).items()
                   if k.endswith(("/mean", "/var")))
    jckpt.check_params_compatible(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                                  ck["params"])

    img = np.random.RandomState(6).randint(0, 256, (SIZE, SIZE, 3), np.uint8)
    ref = JDetector("yolov3", weights_path=path, use_pallas=False,
                    **_yolo64_cfg(False)).detect_one(np_img=img, conf_thres=0.3)
    got = Detector("yolov3", weights_path=path, device="cpu",
                   **_yolo64_cfg(True)).detect_one(np_img=img, conf_thres=0.3)
    assert len(ref) > 0 and len(got) == len(ref)
    np.testing.assert_array_equal(got.classes, ref.classes)
    # the goldens' gates (tests/test_golden_e2e.py): the jitted JAX graph
    # contracts into FMAs where the port rounds op by op
    np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.boxes_xyxy, ref.boxes_xyxy, rtol=0,
                               atol=1e-2)


def test_jax_checkpoint_resumes_in_port(tmp_path, jax_yolo64):
    """A checkpoint JAX's `save_checkpoint` writes after one step of its
    `make_train_step` (params, velocity, step) resumes in the port: the
    port then takes the JAX run's next step, within the step gates."""
    jm, params = jax_yolo64
    jstep = jtraining.make_train_step(jm, input_size=SIZE)
    first = train_batch(0, 2, SIZE, CLASSES)
    second = train_batch(1, 2, SIZE, CLASSES)
    p1, v1, _ = jstep(params, jtraining.sgd_init(params),
                      *map(jnp.asarray, first), PARITY_LR)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, p1, step=1, opt_state=v1)
    p2, _, metrics = jstep(p1, v1, *map(jnp.asarray, second), PARITY_LR)

    step = _port_step(_flat(params))
    assert step.resume(path) == {"step": 1, "extra": {}, "format_version": 2}
    assert_trees_equal(model_tree(step.model), jwi.jax_to_numpy(p1))
    for k, v in from_jax_params(_flat(v1)).items():
        if k in step.velocity:
            assert torch.equal(step.velocity[k], v), k
    p1_port = {k: p.detach().clone() for k, p in step.params.items()}
    terms = step(*second, PARITY_LR)
    for k, v in metrics.items():
        assert float(terms[k]) == pytest.approx(float(v), rel=TRAIN_LOSS_RTOL)
    ref = from_jax_params(_flat(p2))
    p1_ref = from_jax_params(_flat(p1))
    delta = {k: (p - p1_port[k]).detach().numpy()
             for k, p in step.params.items()}
    ref_d = {k: (ref[k] - p1_ref[k]).numpy() for k in delta}
    assert rel_l2(delta, ref_d) <= TRAIN_L2_GATE
    assert min(cosine(delta[k], ref_d[k]) for k in delta) >= TRAIN_COSINE_GATE


def test_resume_checks_geometry(tmp_path, jax_yolo64):
    """A checkpoint of another class count is refused before anything is
    loaded, with the shape mismatch named."""
    _, params = jax_yolo64
    path = str(tmp_path / "c4.npz")
    jckpt.save_checkpoint(path, params)
    model = registry.get_model("yolov3", num_classes=5, input_size=SIZE)
    step = ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        step.resume(path)


def test_check_params_compatible_matches_jax():
    """The same verdicts and the same message as JAX's on a missing, an
    extra and a mis-shaped leaf."""
    expected = {"a": {"w": np.zeros((3, 3, 4, 8))}, "b": np.zeros(8)}
    bad = {"a": {"w": np.zeros((3, 3, 4, 9))}, "c": np.zeros(1)}
    tckpt.check_params_compatible(expected, expected)
    with pytest.raises(ValueError) as got:
        tckpt.check_params_compatible(expected, bad, context=" 'x'")
    with pytest.raises(ValueError) as ref:
        jckpt.check_params_compatible(expected, bad, context=" 'x'")
    # JAX prints the shapes' numpy integers with their type
    assert str(got.value) == re.sub(r"np\.int64\((\d+)\)", r"\1",
                                    str(ref.value))


# ---------------------------------------------------------------------------
# Detector's format guards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def guard_files(tmp_path_factory, yolo_tree):
    """A darknet file, a torchvision-named .pt and a 3-class fcos .npz."""
    root = tmp_path_factory.mktemp("guards")
    weights = str(root / "yolov3.weights")
    twi.save_darknet_weights(yolo_tree, weights)
    pt = str(root / "fcos.pt")
    torch.save({"model": {"backbone.body.conv1.weight": torch.zeros(64, 3, 7, 7)}},
               pt)
    npz = str(root / "fcos3.npz")
    tckpt.save_checkpoint(npz, _template("fcos", num_classes=3, input_size=SIZE))
    return {"weights": weights, "pt": pt, "npz": npz}


GUARDS = {
    "weights_into_retinanet": ("retinanet", "weights", {}, "yolov3/rapid"),
    "pt_into_exp_fcos": ("fcos", "pt", {}, "ltrb_decode"),
    "pt_into_yolov3": ("yolov3", "pt", {}, "no torch-checkpoint importer"),
    "npz_of_other_classes": ("fcos", "npz", {"num_classes": 5},
                             "shape mismatch"),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_detector_format_guards_raise_as_jax(guard_files, case):
    name, kind, cfg, match = GUARDS[case]
    path = guard_files[kind]
    with pytest.raises(ValueError, match=match) as got:
        Detector(name, weights_path=path, device="cpu", input_size=SIZE,
                 **cfg)
    with pytest.raises(ValueError, match=match) as ref:
        JDetector(name, weights_path=path, use_pallas=False,
                  input_size=SIZE, **cfg)
    assert str(got.value).splitlines()[0] == str(ref.value).splitlines()[0]
