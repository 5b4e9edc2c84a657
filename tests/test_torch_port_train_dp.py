"""The port's data-parallel train step on the CPU: two replicas on the
CPU (`parallel.mesh.local_devices` patched to [cpu, cpu], as the JAX
tests run their mesh on virtual CPU devices) against the one-device
step on the whole batch, for every family, and for yolov3 against the
JAX `make_train_step` (the case of `tests/sharding_checks.py`'s
data-parallel step test, run against the port).

Inputs are `chip_smoke.train_batch(0, 4, 64, classes)` (numpy
RandomState), batch 4 split 2 + 2. Per-image convs are bit-equal at
batch 2 and 4 here, so the two steps differ only by the order of the
sums over the batch (BatchNorm's, the losses'): float32 rounding,
which a random-init network amplifies with depth. Measured: loss terms
within 1.7e-6 relative; BN running statistics 9.8e-6 max-scaled on
Darknet-53 and 2.5e-5 on ResNet-50, whose stage 3 is 2 × 2 at 64², so
its statistics are means of 16 values a channel. Gates: the loss terms
1e-5; yolov3 and rapid, whose ignore masks cut hard at IoU 0.6, hold
every parameter and BN statistic to `diff ≤ 0.5·update + 1e-6`
(`sharding_checks.py`'s gate, whose params tree holds the statistics);
fcos and retinanet to chip_smoke's TRAIN_* gates
(`tests/_torch_train_step.py`). Cross-replica BatchNorm alone, on an
uneven 3 + 1 split, is held to JAX's `batch_norm(train=True)` on the
whole batch at float32 rounding.
"""

import copy
import os
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import (  # noqa: E402
    PARITY_LR,
    compare_train_step,
    first_step,
    train_batch,
    write_coco_set,
)
from mydetection_tpu import training as jtraining  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.checkpoint import load_checkpoint as jload  # noqa: E402
from mydetection_tpu.models import layers as JL  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import train as ttrain  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402
from mydetection_tpu_torch.models import layers as TL  # noqa: E402
from mydetection_tpu_torch.models.layers import init_weights  # noqa: E402
from mydetection_tpu_torch.parallel import mesh  # noqa: E402

SIZE, BATCH = 64, 4
CPU = torch.device("cpu")
FAMILIES = ("yolov3", "rapid", "retinanet", "fcos")
SMOOTH = ("retinanet", "fcos")     # held to the TRAIN_* gates
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in the int8 test files: six xdist workers
    on the host's cores otherwise spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def classes_of(name: str) -> int:
    return 1 if name == "rapid" else 4


def batch_of(name: str):
    return train_batch(0, BATCH, SIZE, classes_of(name),
                       rotated=name == "rapid")


def port_model(name: str, flat: dict | None = None, *, init: bool = True):
    """The family at 64², float32: the port's seeded init (none where
    `init` is False: the caller loads weights), or a flat JAX tree."""
    model = registry.get_model(name, num_classes=classes_of(name),
                               compute_dtype=torch.float32, input_size=SIZE)
    if flat is not None:
        model.load_state_dict(from_jax_params(flat), strict=True)
    elif init:
        init_weights(model, 0)
    return model


def step_of(model, replicas: int):
    if replicas == 1:
        return ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    return ttraining.make_train_step(model, input_size=SIZE,
                                     mesh=[CPU] * replicas)


def assert_within_half_update(got: dict, ref: dict) -> None:
    """`sharding_checks.py`'s gate on each parameter's and each BN
    statistic's change in the step, name → array: max|got − ref| ≤
    0.5·max|ref| + 1e-6."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        diff = np.abs(got[k] - r).max()
        assert diff <= 0.5 * np.abs(r).max() + 1e-6, (k, diff)


def changes(run: dict) -> dict:
    """A `first_step` run's parameter updates and BN statistics' moves
    from the init's 0 (mean) and 1 (var), by state_dict name."""
    return {**run["delta"], **{k: v - (1.0 if k.endswith(".var") else 0.0)
                               for k, v in run["bufs"].items()}}


@pytest.fixture(scope="module")
def jax_yolo():
    """yolov3's JAX `init(PRNGKey(0))` tree and one JAX step on the
    whole batch: the flat tree, the metrics, the port-named params
    (BN statistics included) before and after."""
    jm = jget_model("yolov3", num_classes=classes_of("yolov3"),
                    compute_dtype=jnp.float32, input_size=SIZE)
    params = jm.init(jax.random.PRNGKey(0))
    step = jtraining.make_train_step(jm, input_size=SIZE)
    p1, _, metrics = step(params, jtraining.sgd_init(params),
                          *map(jnp.asarray, batch_of("yolov3")),
                          jnp.float32(PARITY_LR))

    def named(tree):
        return {k: t.double().numpy() for k, t in from_jax_params(
            {k: np.asarray(v) for k, v in flatten_tree(tree).items()}).items()}

    p0, p1 = named(params), named(p1)
    return {"flat": {k: np.asarray(v) for k, v in flatten_tree(params).items()},
            "metrics": {k: float(v) for k, v in metrics.items()
                        if k != "bn_updates"},
            "changes": {k: p1[k] - p0[k] for k in p1}}


@pytest.fixture(scope="module")
def runs(jax_yolo):
    """Each family's one-device and data-parallel first step from the
    same weights (yolov3 from the JAX tree, the others from the port's
    seeded init); fcos's data-parallel step is kept for the tests that
    step it again."""
    out = {}
    for name in FAMILIES:
        model = port_model(name, jax_yolo["flat"] if name == "yolov3"
                           else None)
        dp = step_of(copy.deepcopy(model), 2)
        runs = [first_step(step_of(model, 1), batch_of(name)),
                first_step(dp, batch_of(name))]
        if name not in SMOOTH:     # the gate reads the changes alone
            for run in runs:
                run["changes"] = changes(run)
                del run["grads"], run["delta"], run["bufs"]
        out[name] = (*runs, dp if name == "fcos" else None)
        del model, dp
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_data_parallel_step_equals_one_device(runs, name):
    one, dp, _ = runs[name]
    assert set(dp["terms"]) == set(one["terms"])
    for k, v in one["terms"].items():
        assert dp["terms"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    if name in SMOOTH:
        compare_train_step(dp, one, name)
    else:
        assert_within_half_update(dp["changes"], one["changes"])


def test_data_parallel_yolov3_equals_jax_step(runs, jax_yolo):
    """The port's data-parallel step against JAX's `make_train_step` on
    the whole batch from the same `init(PRNGKey(0))` tree, at
    `sharding_checks.py`'s tolerances (loss 1e-5; every leaf, BN
    statistics included, within half its update + 1e-6)."""
    _, dp, _ = runs["yolov3"]
    assert set(dp["terms"]) == set(jax_yolo["metrics"])
    for k, v in jax_yolo["metrics"].items():
        assert dp["terms"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    assert_within_half_update(dp["changes"], jax_yolo["changes"])


def test_replicas_bit_equal_after_two_steps(runs):
    _, _, step = runs["fcos"]
    assert isinstance(step, ttraining.DataParallelTrainStep)
    step(*batch_of("fcos"), PARITY_LR)
    first, second = (m.state_dict() for m in step.replicas)
    assert first.keys() == second.keys()
    for k, v in first.items():
        assert torch.equal(v, second[k]), k
        assert v.data_ptr() != second[k].data_ptr(), k


@pytest.fixture
def scratch():
    """A directory removed after the test: a full-width checkpoint is a
    few hundred MB, which pytest's tmp_path would keep on disk."""
    with tempfile.TemporaryDirectory() as root:
        yield Path(root)


def test_save_resume_round_trips_through_jax_npz(runs, scratch):
    """Replica 0 and the velocity go out in the JAX format (JAX's own
    loader reads the same leaves) and come back into every replica of a
    fresh data-parallel step."""
    _, _, step = runs["fcos"]
    path = str(scratch / "dp.npz")
    step.save(path, step=2)
    ck = jload(path)
    assert ck["step"] == 2
    flat = {k: np.asarray(v) for k, v in flatten_tree(ck["params"]).items()}
    want = {k: v.numpy() for k, v in step.model.state_dict().items()}
    got = {k: t.numpy() for k, t in from_jax_params(flat).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    fresh = step_of(port_model("fcos", init=False), 2)
    assert fresh.resume(path)["step"] == 2
    for m in fresh.replicas:
        for k, v in m.state_dict().items():
            assert torch.equal(v, step.model.state_dict()[k]), k
    for k, v in step.velocity.items():
        assert torch.equal(fresh.velocity[k], v), k


def test_uneven_cross_replica_batch_norm_equals_jax():
    """One train-mode BatchNorm over replicas holding 3 and 1 images
    against JAX's `batch_norm(train=True)` on all 4: the output, the
    running statistics, and the gradients of x, scale and bias."""
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((4, 5, 6, 8)) * 2 + 0.5).astype(np.float32)
    bn_p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "bias": rng.standard_normal(8).astype(np.float32),
            "mean": rng.standard_normal(8).astype(np.float32) * 0.1,
            "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x_, scale, bias):
        y, stats = JL.batch_norm(x_, {**bn_p, "scale": scale, "bias": bias},
                                 train=True)
        return jnp.sum(y * cot), (y, stats)

    (_, (jy, jstats)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(bn_p["scale"]), jnp.asarray(bn_p["bias"]))

    bns = []
    for _ in range(2):
        bn = TL.BatchNorm(8).train()
        with torch.no_grad():
            for k, v in bn_p.items():
                getattr(bn, k).copy_(torch.from_numpy(v))
        bns.append(bn)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    parts = (xt[:3], xt[3:])
    ys = mesh.lockstep([CPU, CPU], [lambda b=b, p=p: b(p)
                                    for b, p in zip(bns, parts)])
    y = torch.cat(ys)
    tcot = torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())
    (y * tcot).sum().backward()

    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    for bn in bns:
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(jstats[k]), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jgrads[0]), rtol=1e-5, atol=1e-5)
    for i, k in ((1, "scale"), (2, "bias")):
        got = sum(getattr(bn, k).grad for bn in bns).numpy()
        np.testing.assert_allclose(got, np.asarray(jgrads[i]), rtol=1e-5,
                                   atol=1e-4)


def test_batch_norm_without_group_is_unchanged():
    """Outside `lockstep` the train-mode BatchNorm is the one-device
    arithmetic, bit for bit: the same layer on the same batch with and
    without a one-replica group."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.standard_normal((3, 8, 5, 7)).astype(np.float32))
    a, b = TL.BatchNorm(8).train(), TL.BatchNorm(8).train()
    ya = a(x)
    [yb] = mesh.lockstep([CPU], [lambda: b(x)])
    assert torch.equal(ya, yb)
    assert torch.equal(a.mean, b.mean) and torch.equal(a.var, b.var)


def test_lockstep_sums_in_replica_order_and_raises():
    """`all_sum` adds tensors in replica order and numbers by `sum`; a
    replica that raises fails the whole group with its error, and
    replicas that take different sums are an error, not a hang."""
    vals = [torch.tensor([1.0, 2.0]), torch.tensor([10.0, 20.0]),
            torch.tensor([100.0, 200.0])]

    def replica(v, n):
        group, rank = mesh.replica_group()
        return group.all_sum(rank, [v, n])

    out = mesh.lockstep([CPU] * 3, [lambda v=v, n=n: replica(v, n)
                                    for n, v in enumerate(vals)])
    for total, count in out:
        assert torch.equal(total, torch.tensor([111.0, 222.0]))
        assert count == 3
    assert mesh.replica_group() is None

    def boom():
        raise KeyError("replica 1")

    with pytest.raises(KeyError, match="replica 1"):
        mesh.lockstep([CPU] * 2, [lambda: replica(vals[0], 0), boom])
    with pytest.raises(RuntimeError, match="different sequences"):
        mesh.lockstep([CPU] * 2, [lambda: replica(vals[0], 0), lambda: 1])


def test_lockstep_stress_more_replicas_than_cores():
    """Twice the host's cores in replicas, a switch interval of 1 µs,
    and 50 sums each, run from a thread joined with a timeout: every
    replica sees every sum whole (a lost or early turn would read
    another round's values)."""
    n = 2 * (os.cpu_count() or 4)
    out = []

    def replica(rank):
        group, _ = mesh.replica_group()
        seen = []
        for i in range(50):
            [t], c = group.all_sum(rank, [torch.tensor([float(rank + i)]),
                                          i])
            seen.append((float(t), c))
        return seen

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: out.append(mesh.lockstep(
            [CPU] * n, [lambda r=r: replica(r) for r in range(n)])))
        runner.start()
        runner.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not runner.is_alive() and len(out) == 1
    want = [(float(sum(r + i for r in range(n))), n * i) for i in range(50)]
    assert out[0] == [want] * n


def test_cross_replica_sum_and_broadcast():
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([3.0, 5.0], requires_grad=True)
    sa, sb = mesh.cross_replica_sum([a, b], [CPU, CPU])
    assert torch.equal(sa, torch.tensor([4.0, 7.0])) and sa is sb
    (sa * torch.tensor([1.0, 10.0])).sum().backward()
    assert torch.equal(a.grad, torch.tensor([1.0, 10.0]))
    assert torch.equal(b.grad, a.grad)
    dst = [torch.zeros(2), torch.zeros(3)]
    mesh.broadcast([torch.ones(2), torch.full((3,), 2.0)], [dst])
    assert torch.equal(dst[0], torch.ones(2))
    assert torch.equal(dst[1], torch.full((3,), 2.0))


def test_mesh_of_one_is_the_single_device_step():
    model = port_model("fcos", init=False)
    with pytest.raises(ValueError, match="mesh's first device"):
        ttraining.make_train_step(model, input_size=SIZE, device="meta",
                                  mesh=[CPU, CPU])
    step = ttraining.make_train_step(model, input_size=SIZE, mesh=[CPU])
    assert type(step) is ttraining.TrainStep and step.device == CPU


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    ann, _ = write_coco_set(str(root), n=4)
    return str(root), ann


@pytest.mark.parametrize("devices", [[CPU], [CPU, CPU]],
                         ids=["one-device", "two-replicas"])
def test_train_cli_data_parallel(coco, devices, scratch, monkeypatch, capsys):
    """`--data-parallel` over one local device is the single-device run
    (a `TrainStep`, no data-parallel line); over two replicas it prints
    the line, trains on a `DataParallelTrainStep` and checkpoints."""
    root, ann = coco
    monkeypatch.setattr(mesh, "local_devices", lambda: list(devices))
    made = []
    make = ttraining.make_train_step

    def recording(*a, **k):
        made.append(make(*a, **k))
        return made[-1]

    monkeypatch.setattr(ttraining, "make_train_step", recording)
    it = ttrain.main(["--model", "fcos", "--ann", ann, "--img-dir", root,
                      "--batch-size", "2", "--iterations", "1", "--sizes",
                      str(SIZE), "--num-threads", "1", "--ckpt-dir",
                      str(scratch), "--device", "cpu", "--float32",
                      "--data-parallel"])
    out = capsys.readouterr().out
    assert it == 1 and os.path.exists(scratch / "fcos_1.npz")
    if len(devices) == 1:
        assert [type(s) for s in made] == [ttraining.TrainStep]
        assert "data-parallel" not in out
    else:
        assert [type(s) for s in made] == [ttraining.DataParallelTrainStep]
        assert "data-parallel over 2 devices" in out
