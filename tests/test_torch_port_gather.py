"""Port parity of the row gather (kernel #8's plain version and wrapper)
against the JAX package on the CPU: the Pallas kernel
`benchmarks/gather_experiments.py::gather_rows_sorted` in interpret
mode on its own contract (sorted indices, duplicates allowed), and the
postprocess's `_rows` on indices in top-k order. The CUDA kernel's legs
are in test_torch_port_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks.gather_experiments import gather_rows_sorted  # noqa: E402
from mydetection_tpu_torch.kernels.gather import (  # noqa: E402
    gather_rows,
    gather_rows_plain,
)
from mydetection_tpu_torch.ops import nms as tnms  # noqa: E402

# N not a multiple of the kernel's 64-row strips; C = 80 classes
B, N, C, K = 2, 1000, 80, 96


def _src(dtype, seed=0):
    src = np.random.RandomState(seed).randn(B, N, C).astype(np.float32)
    return torch.from_numpy(src).to(getattr(torch, dtype))


def _sorted_sel(seed=0):
    """Sorted indices with duplicates, the first and last rows included."""
    rng = np.random.RandomState(seed)
    sel = rng.randint(0, N, (B, K))
    sel[:, :3] = [0, 0, N - 1]
    sel[:, 3:9] = sel[:, 9:10]
    return np.sort(sel, axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_equals_pallas_interpret(dtype):
    src = _src(dtype)
    sel = _sorted_sel()
    assert (sel < N).all() and (sel >= 0).all()
    ref = gather_rows_sorted(jnp.asarray(src.float().numpy(),
                                         getattr(jnp, dtype)),
                             jnp.asarray(sel, jnp.int32), rows=64,
                             interpret=True)
    got = gather_rows_plain(src, torch.from_numpy(sel))
    assert got.dtype == src.dtype and got.shape == (B, K, C)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_equals_rows_on_top_k_order(dtype):
    """Indices as the postprocess passes them: a top-k over each box's
    best score, unsorted by index."""
    src = _src(dtype, 1)
    _, sel = tnms.top_k(src.float().amax(dim=-1), K)
    assert not (sel.diff(dim=1) > 0).all()
    assert (sel < N).all()
    got = gather_rows_plain(src, sel)
    assert torch.equal(got, tnms._rows(src, sel))


@pytest.mark.parametrize("index_dtype", ["int64", "int32"])
def test_wrapper_takes_plain_version_on_cpu(index_dtype):
    src = _src("bfloat16", 2)
    sel = torch.from_numpy(_sorted_sel(2)).to(getattr(torch, index_dtype))
    before = gather_rows.launches
    got = gather_rows(src, sel)
    assert gather_rows.launches == before  # nothing launched
    assert torch.equal(got, gather_rows_plain(src, sel.long()))


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gather_rows(torch.zeros(1, 8, 4, device="meta"),
                    torch.zeros(1, 2, dtype=torch.long, device="meta"))
