"""The port's public surface against the JAX package's: the top-level
names, every registered config, every registered model's dense forward
at 64² on the same weights, `yolov3_608` detect at its registered 608,
and an audit that every public function and class of the JAX package
has a counterpart in the port (or a listed reason why not).
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mydetection_tpu  # noqa: E402
import mydetection_tpu_torch  # noqa: E402
from chip_smoke import golden_image  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.registry import (  # noqa: E402
    default_config as jdefault_config,
    get_model as jget_model,
)
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402
from mydetection_tpu_torch.registry import (  # noqa: E402
    default_config,
    forward_dense,
    get_model,
    list_models,
)

REPO = Path(__file__).resolve().parents[1]
NAMES = ["fcos", "rapid", "retinanet", "retinanet_r101", "yolov3",
         "yolov3_608"]
# the 64² dense forward, float32, port against JAX's jitted forward on
# the same PRNGKey(0) weights: the largest |difference| over the largest
# |JAX value| of each output, within the parity gates' 1e-4 on scores.
# Measured on the CPU: at most 2.9e-05 (rapid's scores; the darknet
# families' 2.0e-05, the RetinaNets' 4.4e-06, fcos's 4.8e-07): XLA fuses
# the jitted convs' epilogues with FMAs and sums in another order
DENSE_GATE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work: in the Tier-1 run
    six workers share the host's cores and torch's per-op thread pools
    spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """name → the JAX PRNGKey(0) init of its registered config, made once
    a name (yolov3_608's serves its 64² forward and its 608 detect)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jget_model(name).init(jax.random.PRNGKey(0))
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# the top-level names
# ---------------------------------------------------------------------------

def test_all_is_jax_all_less_model():
    assert mydetection_tpu_torch.__all__ == sorted(
        set(mydetection_tpu.__all__) - {"Model"})
    assert mydetection_tpu_torch.__version__ == mydetection_tpu.__version__


def _intended(name):
    from mydetection_tpu_torch import api, export, registry, serve

    return {"Detections": api.Detections, "Detector": api.Detector,
            "ModelConfig": registry.ModelConfig,
            "get_model": registry.get_model,
            "list_models": registry.list_models,
            "export_detector": export.export_detector,
            "load_exported": export.load_exported,
            "ExportedDetector": export.ExportedDetector,
            "DetectionServer": serve.DetectionServer}[name]


@pytest.mark.parametrize("name", sorted(set(mydetection_tpu_torch.__all__)
                                        - {"evaluate_coco"}))
def test_top_level_name_resolves(name):
    assert getattr(mydetection_tpu_torch, name) is _intended(name)


def test_unknown_top_level_name_raises():
    with pytest.raises(AttributeError, match="no attribute 'Model'"):
        mydetection_tpu_torch.Model  # noqa: B018


def test_import_leaves_export_serve_and_jax_out():
    """A fresh interpreter: importing the port loads neither its export
    nor its serve module, no JAX, and no `torch.export` module beyond
    those `import torch` itself loads."""
    code = (
        "import sys, torch\n"
        "def tex(): return {m for m in sys.modules "
        "if m == 'torch.export' or m.startswith('torch.export.')}\n"
        "before = tex()\n"
        "import mydetection_tpu_torch\n"
        "bad = sorted(tex() - before) + sorted(m for m in sys.modules if m in "
        "('mydetection_tpu_torch.export', 'mydetection_tpu_torch.serve') or "
        "m == 'jax' or m.startswith('jax.'))\n"
        "print(bad)\n"
        "sys.exit(bool(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_evaluate_coco_forwards(monkeypatch):
    from mydetection_tpu_torch.eval import evaluator

    seen = []

    def fake(*args, **kw):
        seen.append((args, kw))
        return {"AP": 0.5}

    monkeypatch.setattr(evaluator, "evaluate_detector", fake)
    det = object()
    got = mydetection_tpu_torch.evaluate_coco(det, "ann.json", "imgs",
                                              batch_size=4, conf_thres=0.1)
    assert got == {"AP": 0.5}
    assert seen == [((det, "ann.json", "imgs"),
                     {"batch_size": 4, "conf_thres": 0.1})]


# ---------------------------------------------------------------------------
# every registered name against JAX
# ---------------------------------------------------------------------------

def test_registered_names_match_jax():
    assert list_models() == NAMES == mydetection_tpu.list_models()


@pytest.mark.parametrize("name", NAMES)
def test_default_config_matches_jax(name):
    """Field by field; the compute dtype by its name (jnp.bfloat16 ↔
    torch.bfloat16)."""
    got, ref = default_config(name), jdefault_config(name)
    fields = [f.name for f in dataclasses.fields(got)]
    assert fields == [f.name for f in dataclasses.fields(ref)]
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        if f == "compute_dtype":
            assert str(a).removeprefix("torch.") == np.dtype(b).name, name
        else:
            assert a == b, (name, f, a, b)


@pytest.mark.parametrize("name", NAMES)
def test_model_builds_and_runs_like_jax(jax_params, name):
    """The port's counterpart of tests/test_api.py's every-name test:
    each registered name at 64², float32, on the converted JAX
    PRNGKey(0) weights, gives JAX's dense forward: the same keys and
    shapes, every value within DENSE_GATE max-scaled, finite."""
    params = jax_params(name)
    x = np.random.RandomState(0).randint(0, 255, (1, 64, 64, 3), np.uint8)
    jmodel = jget_model(name, input_size=64, compute_dtype=jnp.float32)
    ref = jax.jit(lambda p, x: jmodel.forward_dense(p, x)[0])(params, x)
    model = get_model(name, input_size=64, compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params({
        k: np.asarray(v) for k, v in flatten_tree(params).items()}))
    with torch.inference_mode():
        got = forward_dense(model.eval(), torch.from_numpy(x))
    assert sorted(got) == sorted(ref), name
    for k, v in ref.items():
        v = np.asarray(v, np.float32)
        g = got[k].float().numpy()
        assert g.shape == v.shape and g.shape[1] > 0, (name, k)
        assert np.isfinite(g).all(), (name, k)
        err = np.abs(g - v).max() / max(np.abs(v).max(), 1e-30)
        assert err <= DENSE_GATE, (name, k, err)


def _match_tie_aware(got, ref):
    """One-to-one greedy matching under the goldens' gates: class equal,
    score within rtol 1e-5 / atol 1e-6, box within rtol 1e-4 / atol
    1e-2 px. A permutation of tied rows matches; a wrong row cannot."""
    used = np.zeros(len(ref), bool)
    for box, score, cls in zip(got.boxes_xyxy, got.scores, got.classes):
        cand = (~used & (ref.classes == cls)
                & (np.abs(ref.scores - score) <= 1e-6 + 1e-5 * np.abs(
                    ref.scores))
                & (np.abs(ref.boxes_xyxy - box[None]) <= 1e-2 + 1e-4 * np.abs(
                    ref.boxes_xyxy)).all(axis=1))
        if not cand.any():
            return False
        used[int(np.argmax(cand))] = True
    return True


def test_yolov3_608_detect_matches_jax(jax_params):
    """`Detector("yolov3_608")` at its registered 608 on the golden
    image, float32, the same PRNGKey(0) weights in both packages: the
    goldens' gates (counts equal; scores rtol 1e-5 / atol 1e-6, boxes
    rtol 1e-4 / atol 1e-2 px, classes equal), row by row or, where tied
    rows come out in another order, by a one-to-one match."""
    from mydetection_tpu import Detector as JDetector
    from mydetection_tpu_torch import Detector

    params = jax_params("yolov3_608")
    ref = JDetector("yolov3_608", params=params, compute_dtype=jnp.float32,
                    use_pallas=False).detect_one(
        np_img=golden_image(), conf_thres=0.25, nms_iou=0.45)
    det = Detector("yolov3_608", device="cpu", compute_dtype=torch.float32,
                   params={k: np.asarray(v)
                           for k, v in flatten_tree(params).items()})
    assert det.cfg.input_size == 608
    got = det.detect_one(np_img=golden_image(), conf_thres=0.25,
                         nms_iou=0.45)
    assert len(got) == len(ref) > 0
    row_by_row = (np.array_equal(got.classes, ref.classes)
                  and np.allclose(got.scores, ref.scores, rtol=1e-5,
                                  atol=1e-6)
                  and np.allclose(got.boxes_xyxy, ref.boxes_xyxy, rtol=1e-4,
                                  atol=1e-2))
    assert row_by_row or _match_tie_aware(got, ref)


# ---------------------------------------------------------------------------
# the audit: every public JAX function and class has a port counterpart
# ---------------------------------------------------------------------------

# JAX names whose port counterpart in the same-path module has another
# name: (module, JAX name) → the port's name
RENAMED = {
    ("api", "make_post_one"): "make_post",   # batched, no vmap
    ("losses", "onehot_gather"): "take_along_dim",  # TPU one-hot matmul
    ("ops/nms", "topk_select"): "top_k",     # exact: approx_max_k is TPU-only
    ("weight_import", "jax_to_numpy"): "numpy_tree",
    # functional layers → nn.Modules, functional inits → one seeded init
    ("models/layers", "conv_bn_leaky"): "ConvBNLeaky",
    ("models/layers", "conv_bn_relu"): "ConvBN",
    ("models/layers", "conv_init"): "init_weights",
    ("models/layers", "bn_init"): "init_weights",
    ("models/layers", "kaiming_conv_init"): "init_weights",
    ("models/layers", "conv_bn_leaky_init"): "init_weights",
}
# the Pallas modules → the port's kernel modules: (JAX module) → (port
# module, {JAX name: the port's name})
PALLAS = {
    "ops/pallas/nms_kernel": ("kernels/nms", {"nms_pallas_impl": "nms_keep"}),
    "ops/pallas/rotated_nms_kernel": ("kernels/rotated_nms", {
        "nms_from_iou_pallas_impl": "nms_from_iou_keep"}),
    "ops/pallas/gn_kernel": ("kernels/gn", {
        "bias_gn_relu_pallas_impl": "bias_gn_relu",
        "bias_gn_relu_trainable": "BiasGNReLU"}),
    "ops/pallas/tower_kernel": (
        "kernels/tower", {"conv3x3_chain_pallas_impl": "conv3x3_chain"}),
    "ops/pallas/common": (
        "kernels/nms", {"greedy_fixpoint_keep": "greedy_keep_from_iou"}),
    "ops/pallas/__init__": ("kernels/__init__", {}),
}
# JAX devices the port has no counterpart for, each with its reason
NOT_PORTED = {
    # JAX's Model bundles a config with init / apply; the port's models
    # are nn.Modules built by get_model
    ("registry", "Model"): "functional model",
    **{(m, f): "functional init / apply: the port's models are nn.Modules"
       for m in ("models/darknet", "models/fcos", "models/fpn",
                 "models/resnet", "models/retinanet", "models/yolov3")
       for f in ("init", "apply")},
    ("models/layers", "KeyGen"): "JAX PRNG keys; the port seeds torch",
    ("models/layers", "split2"): "JAX PRNG keys; the port seeds torch",
    ("models/layers", "tree_merge"): "functional BN updates; the port's "
                                     "BatchNorm updates its buffers",
    ("registry", "fast_init"): "the TPU's jitted init",
    ("parallel/mesh", "batch_sharding"): "a JAX NamedSharding; the port "
                                         "places chunks (shard_batch)",
    ("parallel/mesh", "replicated"): "a JAX NamedSharding; the port copies "
                                     "(replicate)",
    ("utils/image_ops", "pack_s2d2"): "the darknet stem's space-to-depth "
                                      "layout (TPU only)",
    **{("utils/profiling", f): "wall timers read by nothing; the port's "
                               "spans (span, recording) time its layers"
       for f in ("timer", "Timer")},
}


def _is_jit_wrapper(name):
    """The `*_impl` functions: jitted entry points of a JAX op whose port
    counterpart is the op itself."""
    return name.endswith("_impl")


def _public_defs(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _bound_names(path: Path) -> set:
    """Every name a module binds at its top level: defs, classes,
    assignments and imports."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


JAX_MODULES = sorted(p.relative_to(REPO / "mydetection_tpu").with_suffix(
    "").as_posix() for p in (REPO / "mydetection_tpu").rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_every_public_jax_name(module):
    jax_path = REPO / "mydetection_tpu" / f"{module}.py"
    if module in PALLAS:
        port_module, names = PALLAS[module]
        port = _bound_names(REPO / "mydetection_tpu_torch"
                            / f"{port_module}.py")
        missing = sorted(n for n in _public_defs(jax_path)
                         if names.get(n) not in port)
        assert not missing, (module, port_module, missing)
        return
    port_path = REPO / "mydetection_tpu_torch" / f"{module}.py"
    assert port_path.exists(), f"no port module for {module}"
    port = _bound_names(port_path)
    missing = []
    for name in sorted(_public_defs(jax_path)):
        if (module, name) in NOT_PORTED or _is_jit_wrapper(name):
            continue
        if RENAMED.get((module, name), name) not in port:
            missing.append(name)
    assert not missing, (module, missing)


def test_audit_tables_name_real_jax_names():
    """Every entry of the tables names a public JAX function or class
    that exists, so a name the JAX package drops leaves no stale
    exception behind."""
    for module, name in [*RENAMED, *NOT_PORTED]:
        assert name in _public_defs(REPO / "mydetection_tpu"
                                    / f"{module}.py"), (module, name)
    for module, (_, names) in PALLAS.items():
        assert set(names) == _public_defs(REPO / "mydetection_tpu"
                                          / f"{module}.py"), module
