"""The port's kernel build (``predictionio_tpu_torch/ops/_build.py``) on the
CPU: what names a built library. Nothing here compiles."""

import shutil

import pytest

from predictionio_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``ops/csrc`` that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "_CSRC", copy)
    monkeypatch.setattr(_build, "SOURCES", {name: copy / src.name for name, src in _build.SOURCES.items()})
    return copy


def test_every_source_and_header_exists():
    assert all(src.is_file() for src in _build.SOURCES.values())
    assert sorted(h.name for h in _build._CSRC.glob("*.cuh"))


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_is_stable_and_under_the_build_dir(csrc_copy, name):
    path = _build.lib_path(name)
    assert path == _build.lib_path(name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_editing_a_header_changes_the_library_path(csrc_copy, name):
    before = _build.lib_path(name)
    header = sorted(csrc_copy.glob("*.cuh"))[0]
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.lib_path(name) != before


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_editing_the_source_changes_the_library_path(csrc_copy, name):
    before = _build.lib_path(name)
    src = _build.SOURCES[name]
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _build.lib_path(name) != before
