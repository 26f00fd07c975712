"""The port's kernel builder (``repro_torch.kernels.build``) names each
library by a digest of what it is compiled from, so an edited source, an
edited header beside it or other compiler flags never load a stale
library.  Only the naming runs here: compiling needs ``nvcc`` and a card
(``chip_smoke.py``)."""

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "kernel.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return g(); }\n')
    (d / "helpers.cuh").write_text("inline int g() { return 1; }\n")
    return d


def test_library_path_is_stable_and_named_after_the_source(csrc):
    source = csrc / "kernel.cu"
    path = build.library_path(source)
    assert path == build.library_path(source)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libkernel-") and path.suffix == ".so"


@pytest.mark.parametrize(
    "edit",
    [
        lambda d: (d / "helpers.cuh").write_text("inline int g() { return 2; }\n"),
        lambda d: (d / "kernel.cu").write_text('extern "C" int f() { return 3; }\n'),
        lambda d: (d / "more.cuh").write_text("// a new header\n"),
    ],
    ids=["edited header", "edited source", "new header"],
)
def test_library_path_changes_with_any_file_beside_the_source(csrc, edit):
    source = csrc / "kernel.cu"
    before = build.library_path(source)
    edit(csrc)
    assert build.library_path(source) != before


def test_library_path_changes_with_the_compiler_flags(csrc, monkeypatch):
    source = csrc / "kernel.cu"
    before = build.library_path(source)
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert build.library_path(source) != before
