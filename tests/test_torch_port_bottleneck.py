"""Port parity of the fused stride-1 bottleneck (kernel #7's plain
version, the fold and the route in `models/resnet.py`) against the JAX
package on the CPU.

`fused_block`, the TPU kernel, is nested in `benchmarks/
resnet_stage_experiments.py::main` and cannot be imported or run in
interpret mode, so JAX `resnet._bottleneck(train=False)` is the oracle:
≤ 1e-5 max-scaled in float32 (the fold moves BN before the conv, the
sums reassociate), < 0.05 in bf16 (the TPU script's own gate for its
kernel against that XLA chain: the kernel rounds once per conv after
the float32 bias, JAX rounds the conv and then applies BN in bf16).
The CUDA kernel's legs are in test_torch_port_cuda.py.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.models import resnet as jresnet  # noqa: E402
from mydetection_tpu.models.layers import KeyGen  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402
from mydetection_tpu_torch.kernels.bottleneck import (  # noqa: E402
    Folded,
    fold_bottleneck,
    fused_bottleneck,
    fused_bottleneck_plain,
)
from mydetection_tpu_torch.models import resnet as tresnet  # noqa: E402
from mydetection_tpu_torch.models.layers import BatchNorm  # noqa: E402

# name → (c_in, c_out, projection); c_mid = c_out / 4 = 16
CASES = {"projection": (32, 64, True), "identity": (64, 64, False)}
MAPS = [(8, 8), (7, 11)]
GATES = {"float32": 1e-5, "bfloat16": 0.05}
ROUTED = ["stage0.block0", "stage0.block1", "stage0.block2",
          "stage1.block1", "stage1.block2", "stage1.block3"]


def _params(case: str, seed: int = 0) -> dict:
    """JAX `_bottleneck_init` parameters with every BN randomised: mean
    0.1·N(0, 1) and var U(0.5, 2) as the TPU script draws them, scale
    1 + 0.1·N(0, 1), bias 0.1·N(0, 1)."""
    c_in, c_out, down = CASES[case]
    p = jresnet._bottleneck_init(KeyGen(jax.random.PRNGKey(seed)), c_in,
                                 c_out, downsample=down)
    rng = np.random.RandomState(seed)
    for cv in p.values():
        c = cv["bn"]["mean"].shape
        cv["bn"] = {"mean": 0.1 * rng.standard_normal(c),
                    "var": rng.uniform(0.5, 2.0, c),
                    "scale": 1.0 + 0.1 * rng.standard_normal(c),
                    "bias": 0.1 * rng.standard_normal(c)}
        cv["bn"] = {k: jnp.asarray(v, jnp.float32) for k, v in cv["bn"].items()}
    return p


def _x(case: str, hw, seed: int = 1) -> np.ndarray:
    """NHWC float32 input with a non-zero mean."""
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((2, *hw, CASES[case][0])) + 0.5).astype(
        np.float32)


def _tpu_fold(cv: dict):
    """The TPU script's `fold` (resnet_stage_experiments.py:69-74), in
    float32: (HWIO w·s, bias − mean·s)."""
    w, bn = cv["conv"]["w"], cv["bn"]
    s = bn["scale"] * jax.lax.rsqrt(bn["var"] + 1e-5)
    return w * s[None, None, None, :], (bn["bias"] - bn["mean"] * s).astype(
        jnp.float32)


def _tpu_folded(p: dict, dtype) -> Folded:
    """`_tpu_fold` of each conv, packed as the kernel takes it: HWIO
    (kh, kw, c_in, c_out) → (kh·kw·c_in, c_out) cast to `dtype`."""
    out = []
    for name in ("conv1", "conv2", "conv3", "down"):
        if name in p:
            w, b = _tpu_fold(p[name])
            w = torch.from_numpy(np.array(w)).reshape(-1, w.shape[-1])
            out += [w.to(dtype), torch.from_numpy(np.array(b))]
    return Folded(*out)


def _port_block(p: dict, fused: bool = True) -> tresnet.Bottleneck:
    """A port Bottleneck loaded from the JAX tree through the bridge."""
    c_in = p["conv1"]["conv"]["w"].shape[2]
    c_out = p["conv3"]["conv"]["w"].shape[3]
    block = tresnet.Bottleneck(c_in, c_out, 1, "down" in p, fused=fused)
    flat = {k: np.asarray(v) for k, v in flatten_tree(p).items()}
    block.load_state_dict(from_jax_params(flat), strict=True)
    return block.eval()


def _nchw(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)


def _max_scaled(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _jax_bottleneck(p, x: np.ndarray, dtype: str) -> np.ndarray:
    jdt = getattr(jnp, dtype)
    y, _ = jresnet._bottleneck(p, jnp.asarray(x).astype(jdt), stride=1,
                               train=False, compute_dtype=jdt)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("hw", MAPS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_bottleneck(dtype, case, hw):
    """The plain version on the TPU script's fold against JAX
    `_bottleneck(train=False)`, max-scaled, within GATES."""
    p = _params(case)
    x = _x(case, hw)
    tdt = getattr(torch, dtype)
    got = fused_bottleneck_plain(_nchw(x, tdt), *_tpu_folded(p, tdt))
    assert got.dtype == tdt
    err = _max_scaled(got.float().permute(0, 2, 3, 1).numpy(),
                      _jax_bottleneck(p, x, dtype))
    assert err <= GATES[dtype], err


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_bottleneck_matches_tpu_fold(dtype, case):
    """`fold_bottleneck` on a port Bottleneck loaded through
    `from_jax_params` packs what the TPU script's fold gives (float32
    weights within one ulp, the same layout, the same dtypes), and the
    plain version gives the same output from either."""
    p = _params(case)
    tdt = getattr(torch, dtype)
    ours = fold_bottleneck(_port_block(p), tdt)
    ref = _tpu_folded(p, tdt)
    assert len(ours) == len(ref) == 8
    for name, a, b in zip(Folded._fields, ours, ref):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.is_contiguous() and not a.requires_grad, name
        tol = 2e-7 if a.dtype == torch.float32 else 8e-3
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=tol, atol=1e-7, err_msg=name)
    x = _nchw(_x(case, MAPS[1]), tdt)
    err = _max_scaled(fused_bottleneck_plain(x, *ours).float(),
                      fused_bottleneck_plain(x, *ref).float())
    assert err <= (1e-6 if dtype == "float32" else 1e-2), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_forward_is_the_jax_bottleneck(case):
    """A routed block's CPU forward is the unfused JAX arithmetic,
    bit for bit the same as `unfused`, within 1e-6 of JAX in float32,
    and launches nothing."""
    p = _params(case)
    block = _port_block(p)
    x = _x(case, MAPS[1])
    before = fused_bottleneck.launches
    with torch.no_grad():
        got = block(_nchw(x, torch.float32))
        assert torch.equal(got, block.unfused(_nchw(x, torch.float32)))
    assert fused_bottleneck.launches == before
    err = _max_scaled(got.permute(0, 2, 3, 1).numpy(),
                      _jax_bottleneck(p, x, "float32"))
    assert err <= 1e-6, err


@pytest.mark.parametrize("depth", [50, 101])
def test_route_takes_six_stride1_blocks_in_eval(depth):
    """Exactly stage 0's blocks and stage 1's blocks 1-3 are routed,
    all at stride 1; on the card they take the kernel only in eval mode
    with no gradient needed, and a CPU tensor never does."""
    model = tresnet.ResNet(depth)
    blocks = {n: m for n, m in model.named_modules()
              if isinstance(m, tresnet.Bottleneck)}
    assert [n for n, m in blocks.items() if m.fused] == ROUTED
    assert all(blocks[n].conv2.stride == 1 for n in ROUTED)
    assert all(m.conv2.stride == 2 for n, m in blocks.items()
               if n.endswith("block0") and not n.startswith("stage0"))
    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    requires_grad=False)
    takes = lambda: [n for n, m in blocks.items()  # noqa: E731
                     if m.takes_kernel(on_card)]
    model.train()
    with torch.no_grad():
        assert takes() == []
    model.eval()
    assert takes() == []          # parameters that need gradients
    with torch.no_grad():
        assert takes() == ROUTED
    model.requires_grad_(False)
    assert takes() == ROUTED
    with torch.no_grad():
        assert not any(m.takes_kernel(torch.zeros(1, 64, 4, 4))
                       for m in blocks.values())


def test_route_refuses_a_stride2_block():
    with pytest.raises(ValueError, match="stride 1"):
        tresnet.Bottleneck(256, 512, 2, True, fused=True)


def test_routed_resnet_runs_the_plain_fused_blocks(monkeypatch):
    """The route end to end on the CPU: with every routed block taking
    the kernel path (the plain version on a CPU tensor), a ResNet-50
    forward calls `fused_bottleneck` six times, through the module-level
    name, on the folded weights, at stage 0's and stage 1's maps, and
    its features stay within 1e-5 max-scaled of the unfused forward."""
    model = tresnet.ResNet(50).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(0.5 + 1.5 * torch.rand(m.var.shape, generator=gen))
    x = torch.randn(1, 3, 64, 64, generator=gen)
    with torch.no_grad():
        ref = model(x)
        calls = []

        def record(x, *folded):
            calls.append((tuple(x.shape), folded))
            return fused_bottleneck_plain(x, *folded)

        monkeypatch.setattr(tresnet.Bottleneck, "takes_kernel",
                            lambda self, x: self.fused)
        monkeypatch.setattr(tresnet, "fused_bottleneck", record)
        got = model(x)
    assert [s for s, _ in calls] == [(1, 64, 16, 16)] + [(1, 256, 16, 16)] * 2 \
        + [(1, 512, 8, 8)] * 3
    assert [f[6] is not None for _, f in calls] == [True] + [False] * 5
    for g, r in zip(got, ref):
        assert _max_scaled(g.numpy(), r.numpy()) <= 1e-5


def test_fused_bottleneck_refuses_other_devices():
    x = torch.empty(1, 64, 4, 4, device="meta")
    f = Folded(*(torch.empty(s, device="meta") for s in
                 [(64, 16), (16,), (144, 16), (16,), (16, 64), (64,)]))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bottleneck(x, *f)


def test_cpu_wrapper_is_the_plain_version():
    p = _params("projection")
    x = _nchw(_x("projection", MAPS[0]), torch.bfloat16)
    folded = fold_bottleneck(_port_block(p), torch.bfloat16)
    before = fused_bottleneck.launches
    assert torch.equal(fused_bottleneck(x, *folded),
                       fused_bottleneck_plain(x, *folded))
    assert fused_bottleneck.launches == before
