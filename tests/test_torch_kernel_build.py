"""The kernel libraries' names follow their sources and the headers those
include, so an edited header is never served by a stale library. No nvcc:
only the paths are computed, on a copy of ``csrc/``."""

import shutil

from vcoder_tpu_torch.ops import _kernels


def _copy_csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_kernels.SRC_DIR, src)
    monkeypatch.setattr(_kernels, "SRC_DIR", src)
    return src


def test_library_path_follows_an_included_header(tmp_path, monkeypatch):
    src = _copy_csrc(tmp_path, monkeypatch)
    before = {n: _kernels._lib_path(n) for n in ("gemm_bias", "vit_mlp", "flash_fwd")}
    header = src / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _kernels._lib_path(n) for n in before}
    # Both sources that include the header get new names; one that does not
    # keeps its own.
    assert after["gemm_bias"] != before["gemm_bias"]
    assert after["vit_mlp"] != before["vit_mlp"]
    assert after["flash_fwd"] == before["flash_fwd"]


def test_library_path_follows_nested_includes_and_the_source(tmp_path, monkeypatch):
    src = _copy_csrc(tmp_path, monkeypatch)
    (src / "inner.cuh").write_text("// inner\n")
    header = src / "gemm_sm90.cuh"
    header.write_text(header.read_text() + '\n#include "inner.cuh"\n')
    assert _kernels._sources(src / "gemm_bias.cu") == [
        src / "gemm_bias.cu", src / "gemm_sm90.cuh", src / "inner.cuh", src / "sm90.cuh"]
    p0 = _kernels._lib_path("gemm_bias")
    (src / "inner.cuh").write_text("// inner, edited\n")
    p1 = _kernels._lib_path("gemm_bias")
    (src / "gemm_bias.cu").write_text((src / "gemm_bias.cu").read_text() + "\n")
    p2 = _kernels._lib_path("gemm_bias")
    assert len({p0, p1, p2}) == 3
    assert p2.parent == _kernels.BUILD_DIR and p2.name.startswith("libgemm_bias-")


def test_library_path_follows_the_shared_hopper_header(tmp_path, monkeypatch):
    src = _copy_csrc(tmp_path, monkeypatch)
    names = ("flash_fwd", "gemm_bias", "vit_mlp", "int4_matmul")
    assert src / "sm90.cuh" in _kernels._sources(src / "flash_fwd.cu")
    before = {n: _kernels._lib_path(n) for n in names}
    header = src / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _kernels._lib_path(n) for n in names}
    # flash_fwd.cu includes it directly, the GEMMs through gemm_sm90.cuh; the
    # int4 kernel includes neither.
    for n in ("flash_fwd", "gemm_bias", "vit_mlp"):
        assert after[n] != before[n], n
    assert after["int4_matmul"] == before["int4_matmul"]


def test_backward_library_path_follows_the_shared_hopper_header(tmp_path, monkeypatch):
    src = _copy_csrc(tmp_path, monkeypatch)
    assert src / "sm90.cuh" in _kernels._sources(src / "flash_bwd.cu")
    before = {n: _kernels._lib_path(n) for n in ("flash_bwd", "paged_attn", "int4_matmul")}
    header = src / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    # The backward includes it, and the paged kernel (its SPLIT body's
    # mbarriers); the int4 kernel does not.
    assert _kernels._lib_path("flash_bwd") != before["flash_bwd"]
    assert _kernels._lib_path("paged_attn") != before["paged_attn"]
    assert _kernels._lib_path("int4_matmul") == before["int4_matmul"]


def test_int8_library_path_follows_the_shared_hopper_header(tmp_path, monkeypatch):
    src = _copy_csrc(tmp_path, monkeypatch)
    # The s8 GEMM includes sm90.cuh directly (its wgmma, TMA and tensor-map
    # primitives), not the bf16 mainloop of gemm_sm90.cuh.
    assert _kernels._sources(src / "int8_mm.cu") == [src / "int8_mm.cu", src / "sm90.cuh"]
    before = {n: _kernels._lib_path(n) for n in ("int8_mm", "int4_matmul")}
    header = src / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _kernels._lib_path("int8_mm") != before["int8_mm"]
    assert _kernels._lib_path("int4_matmul") == before["int4_matmul"]
    mid = _kernels._lib_path("int8_mm")
    (src / "gemm_sm90.cuh").write_text((src / "gemm_sm90.cuh").read_text() + "\n// edited\n")
    assert _kernels._lib_path("int8_mm") == mid


def test_ctypes_signatures_match_the_c_entry_points():
    """Each entry point's argument list in ``_SIGNATURES`` has as many
    arguments as its ``extern "C"`` definition in ``csrc/<name>.cu``: ctypes
    would pass a shifted list silently."""
    import re

    for name, syms in _kernels._SIGNATURES.items():
        text = (_kernels.SRC_DIR / f"{name}.cu").read_text()
        for sym, argtypes in syms.items():
            m = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)", text)
            assert m is not None, (name, sym)
            assert len(m.group(1).split(",")) == len(argtypes), (name, sym)
