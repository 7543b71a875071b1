"""The port's kernel build: library names follow every byte that is compiled.

``_build`` names each library by a hash of its ``csrc`` source, the
``csrc`` headers that source includes and the compiler flags, so an edit
to any of them builds a new library.  Nothing is compiled here.
"""

import pytest

pytest.importorskip("torch")

from repro_torch import _build  # noqa: E402


def test_library_name_follows_the_source_and_its_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')  # a cycle is read once
    names = [_build._library_path("k").name]
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint b;\n')
    names.append(_build._library_path("k").name)
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint k2;\n')
    names.append(_build._library_path("k").name)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    names.append(_build._library_path("k").name)
    assert all(n.startswith("k-") and n.endswith(".so") for n in names)
    assert len(set(names)) == 4
    assert _build._library_path("k").name == names[-1]  # unchanged inputs, same library


def test_every_source_includes_only_headers_that_exist():
    for name in _build.SOURCES:  # a missing csrc header raises here
        assert _build._library_path(name).parent == _build.BUILD_DIR


def test_every_source_defines_its_error_string():
    # function() resolves <name>_error_string in each library it loads,
    # and build() compiles every source, the wide forward's with the others
    assert "flash_attention_wide" in _build.SOURCES
    for name in _build.SOURCES:
        text = (_build.SRC_DIR / f"{name}.cu").read_text()
        assert f"const char* {name}_error_string(int err)" in text, name


def test_setup_seconds_names_what_was_built_and_loaded(tmp_path, monkeypatch):
    """``setup_seconds`` lists a library under "built" only where this
    process ran nvcc on it, and under "loaded" once it is loaded."""
    import types

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("int k;\n")
    nvcc = tmp_path / "nvcc"   # writes the file after -o, as nvcc would
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    for name in ("_libs", "_functions", "_built", "_loaded"):
        monkeypatch.setattr(_build, name, {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        k_error_string=types.SimpleNamespace(), k_launch=types.SimpleNamespace()))
    assert _build.setup_seconds() == {"built": {}, "loaded": {}}
    _build.function("k", "k_launch", [])
    first = _build.setup_seconds()
    assert set(first["built"]) == set(first["loaded"]) == {"k"}
    assert first["built"]["k"] > 0 and first["loaded"]["k"] >= 0
    _build.build(["k"])                 # already built: nvcc does not run
    _build.function("k", "k_launch", [])
    assert _build.setup_seconds() == first
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "_built", {})   # a later process finds it built
    monkeypatch.setattr(_build, "_loaded", {})
    _build.function("k", "k_launch", [])
    assert _build.setup_seconds()["built"] == {} and "k" in _build.setup_seconds()["loaded"]
