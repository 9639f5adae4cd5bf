"""The kernel build's cache key, on the CPU (nothing is compiled here).

A library is named by a digest of its source, every ``csrc/*.cuh`` header
and the nvcc flags: an edited header must give a new library name, or a
launch would load a library built from the old header.
"""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "source", "new header"])
def test_library_path_follows_sources_and_headers(csrc, edit):
    before = build.library_path("k")
    assert build.library_path("k") == before          # stable when unchanged
    if edit == "header":
        (csrc / "h.cuh").write_text("// v2\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    else:
        (csrc / "g.cuh").write_text("// another\n")
    after = build.library_path("k")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("libk-")


def test_library_path_ignores_other_sources(csrc):
    before = build.library_path("k")
    (csrc / "other.cu").write_text("// another kernel\n")
    assert build.library_path("k") == before
