"""The port's kernel build on the CPU: which sources `build.py` compiles,
and that a library's cache key covers every shared header, so an edited
`csrc/*.cuh` never loads a stale build. No nvcc is needed: nothing here
compiles."""

import shutil

import pytest

pytest.importorskip("torch")

from mydetection_tpu_torch.kernels import build  # noqa: E402

WGMMA_SOURCES = ["tower", "bottleneck"]


def code(name: str) -> str:
    """csrc/<name>.cu without its // comments."""
    text = (build.CSRC / f"{name}.cu").read_text()
    return "\n".join(line.split("//")[0] for line in text.splitlines())


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.py reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_sources_are_the_kernels_not_the_headers():
    names = build.sources()
    assert names == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert {"bottleneck", "tower", "gn", "nms"} <= set(names)
    assert "hopper" not in names
    assert (build.CSRC / "hopper.cuh").exists()


@pytest.mark.parametrize("name", build.sources())
def test_library_path_changes_with_a_shared_header(csrc, name):
    before = build.library_path(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(name)
    assert after != before
    assert after.parent == build.BUILD_DIR
    assert after.name.startswith(f"{name}-") and after.suffix == ".so"


def test_library_path_changes_with_a_new_header(csrc):
    before = build.library_path("bottleneck")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("bottleneck") != before


def test_library_path_changes_only_with_its_own_source(csrc):
    tower, bottleneck = (build.library_path(n) for n in WGMMA_SOURCES)
    src = csrc / "bottleneck.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("tower") == tower
    assert build.library_path("bottleneck") != bottleneck


def test_library_path_is_stable():
    assert all(build.library_path(n) == build.library_path(n)
               for n in build.sources())


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_wgmma_kernels_share_the_hopper_header(name):
    """The mbarrier, TMA and wgmma helpers live once, in hopper.cuh."""
    text = code(name)
    assert '#include "hopper.cuh"' in text
    for helper in ("void mbar_wait(", "uint64_t sw128_desc(",
                   "Fn libcuda_entry(", "void fence_acc("):
        assert helper not in text, helper


def test_bottleneck_bf16_path_is_wgmma_fed_by_tma():
    text = code("bottleneck")
    for gone in ("nvcuda", "wmma::", "<mma.h>", "mma.sync"):
        assert gone not in text, gone
    for used in ("wgmma_ss_n128(", "wgmma_rs<CM>(", "tma_load_4d(",
                 "tma_store_4d(", "setmaxnreg"):
        assert used in text, used
