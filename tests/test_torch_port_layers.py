"""Port parity, module by module: the weight bridge, the layers, and
Darknet-53 + the YOLOv3 head + the single-label decode at a small input.

Same inputs (numpy, seeded) through the JAX function and its port, in
float32 on the CPU. Gates are norm-relative (`_rel_close`: error over
the reference's max |value|), never rtol-only near 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.models import darknet as jdarknet  # noqa: E402
from mydetection_tpu.models import layers as JL  # noqa: E402
from mydetection_tpu.models import yolov3 as jyolo  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402
from mydetection_tpu_torch.models import layers as TL  # noqa: E402
from mydetection_tpu_torch.models import yolov3 as tyolo  # noqa: E402
from mydetection_tpu_torch.registry import get_model  # noqa: E402


def _rel_close(a, b, tol):
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               atol=tol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX yolov3 init(PRNGKey(0)) tree."""
    return jget_model("yolov3").init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_flat(jax_tree):
    return {k: np.asarray(v) for k, v in flatten_tree(jax_tree).items()}


@pytest.fixture(scope="module")
def port_model(jax_flat):
    model = get_model("yolov3", compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params(jax_flat), strict=True)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trip(jax_flat, port_model):
    """JAX tree → state_dict → module → state_dict → JAX tree: zero
    missing or extra keys either way, every value back bit for bit."""
    sd = from_jax_params(jax_flat)
    assert set(sd) == set(port_model.state_dict())
    back = {}
    for key, val in port_model.state_dict().items():
        *path, leaf = key.split(".")
        arr = val.numpy()
        if leaf == "weight":
            leaf, arr = "w", arr.transpose(2, 3, 1, 0)
        elif leaf == "bias" and path[-1] == "out":
            leaf = "b"
        back["/".join([*path, leaf])] = arr
    assert set(back) == set(jax_flat)
    for key, arr in jax_flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_bridge_rejects_missing_and_extra_keys(jax_flat):
    model = get_model("yolov3")
    sd = from_jax_params(jax_flat)
    missing = dict(sd)
    missing.pop("head.head3.out.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
    extra = dict(sd, **{"head.head3.extra": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(extra, strict=True)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,ksize", [(1, 3), (2, 3), (1, 1), (2, 1)])
def test_conv2d_matches_jax(stride, ksize):
    rng = np.random.RandomState(ksize * 10 + stride)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)  # even: the s2 pad trap
    w = rng.randn(ksize, ksize, 8, 12).astype(np.float32)
    ref = np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = TL.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    stride=stride)
    assert _nhwc(got).shape == ref.shape
    _rel_close(_nhwc(got), ref, 1e-5)


def test_batch_norm_fold_matches_jax():
    rng = np.random.RandomState(1)
    c = 16
    bn = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.5, c),
          "mean": rng.normal(0, 0.5, c), "var": rng.uniform(0.5, 1.5, c)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    ref, _ = JL.batch_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                            for k, v in bn.items()})
    mod = TL.BatchNorm(c).eval()  # train mode takes the batch's statistics
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in bn.items()})
    _rel_close(_nhwc(mod(_nchw(x))), np.asarray(ref), 1e-6)


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(2).randn(4, 64).astype(np.float32) * 3
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    ref = np.asarray(JL.leaky_relu(jnp.asarray(x)))
    got = TL.leaky_relu(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_input_matches_jax(dtype):
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    ref = JL.normalize_input(jnp.asarray(u8), getattr(jnp, dtype))
    got = TL.normalize_input(torch.from_numpy(u8), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_upsample2x_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(JL.upsample2x(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(TL.upsample2x(_nchw(x))), ref)


# ---------------------------------------------------------------------------
# backbone, head and decode at a small input
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_run(jax_tree, port_model):
    """Both frameworks on one 64² uint8 batch: (jax C3-5, jax raw heads,
    port C3-5 NHWC, port raw heads)."""
    u8 = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)

    @jax.jit
    def jax_forward(tree, u8):
        x = JL.normalize_input(u8, jnp.float32)
        feats, _ = jdarknet.apply(tree["backbone"], x, compute_dtype=jnp.float32,
                                  s2d_stem=False, scan_blocks=False)
        raw, _ = jyolo.apply(tree["head"], feats, compute_dtype=jnp.float32)
        return feats, raw

    jfeats, jraw = jax_forward(jax_tree, u8)
    images = torch.from_numpy(u8)
    with torch.no_grad():
        tfeats = port_model.backbone(
            TL.normalize_input(images.permute(0, 3, 1, 2), torch.float32))
        traw = port_model(images)
    return ([np.asarray(f) for f in jfeats], [np.asarray(r) for r in jraw],
            [_nhwc(f) for f in tfeats], [r.numpy() for r in traw])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_darknet_features_match_jax(small_run, level):
    jfeats, _, tfeats, _ = small_run
    assert tfeats[level].shape == jfeats[level].shape
    _rel_close(tfeats[level], jfeats[level], 1e-5)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_yolov3_raw_heads_match_jax(small_run, level):
    _, jraw, _, traw = small_run
    assert traw[level].shape == jraw[level].shape  # NHWC (B, H, W, A*(5+C))
    _rel_close(traw[level], jraw[level], 1e-5)


def test_decode_single_label_matches_jax():
    """The same raw heads through both decoders; scaled so sigmoids are
    unsaturated and some twh pass the ±TWH_CLAMP clip."""
    rng = np.random.RandomState(5)
    raws = [rng.randn(2, s, s, 3 * 85).astype(np.float32) * 4
            for s in (2, 4, 8)]
    ref = jax.jit(jyolo.decode_single_label, static_argnums=1)(
        [jnp.asarray(r) for r in raws], 80)
    got = tyolo.decode_single_label([torch.from_numpy(r) for r in raws], 80)
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(ref["classes"]))
    _rel_close(got["scores"].numpy(), np.asarray(ref["scores"]), 1e-6)
    _rel_close(got["boxes"].numpy(), np.asarray(ref["boxes"]), 1e-6)


def test_decode_flattens_cells_row_major_anchors_minor():
    """One hot logit at cell (y=1, x=2), anchor 1 of P4 must decode to
    that cell's centre with that anchor's size."""
    raws = [torch.full((1, s, s, 3 * 85), -20.0) for s in (2, 4, 8)]
    raws[1][0, 1, 2, 85:85 + 4] = 0.0       # anchor 1: txy = twh = 0
    raws[1][0, 1, 2, 85 + 4] = 20.0         # objectness
    raws[1][0, 1, 2, 85 + 5 + 7] = 20.0     # class 7
    out = tyolo.decode_single_label(raws, 80)
    i = int(out["scores"][0].argmax())
    assert i == 2 * 2 * 3 + (1 * 4 + 2) * 3 + 1
    assert int(out["classes"][0, i]) == 7
    np.testing.assert_allclose(out["boxes"][0, i].numpy(),
                               [2.5 * 16, 1.5 * 16, 62, 45])
