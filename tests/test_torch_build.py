"""The port's kernel build cache: a library is named after a hash of its
source, the headers beside it and the flags, so editing a header that a
source includes rebuilds that source's library."""

import pytest

from pytorch_zappa_serverless_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "x.cu").write_text('#include "h.cuh"\nextern "C" int f() { return 0; }\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_is_stable_when_nothing_changes(csrc):
    first = _build.library_path("x.cu")
    assert _build.library_path("x.cu") == first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("x-")


@pytest.mark.parametrize("edit", [
    lambda d: (d / "h.cuh").write_text("#pragma once\n// edited\n"),  # a header changes
    lambda d: (d / "new.cuh").write_text("#pragma once\n"),           # a header is added
    lambda d: (d / "x.cu").write_text("// edited\n"),                 # the source changes
])
def test_library_path_changes_with_the_source_or_a_header(csrc, edit):
    before = _build.library_path("x.cu")
    edit(csrc)
    assert _build.library_path("x.cu") != before


def test_library_path_changes_with_the_flags(csrc, monkeypatch):
    before = _build.library_path("x.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("x.cu") != before
