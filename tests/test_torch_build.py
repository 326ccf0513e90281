"""The port's kernel build (tpu_docker_api_torch/_build.py) without nvcc:
a library's name follows its source and the headers it may include, and
the SASS counts read cuobjdump's listing, for the library and for each of
its kernels."""

import subprocess

from tpu_docker_api_torch import _build


def test_library_path_follows_source_and_headers(tmp_path, monkeypatch):
    (tmp_path / "flash_fwd.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_SRC_DIR", tmp_path)
    first = _build.library_path("flash_fwd")
    assert first == _build.library_path("flash_fwd")
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _build.library_path("flash_fwd")
    (tmp_path / "flash_fwd.cu").write_text('#include "hopper.cuh"\n// x\n')
    third = _build.library_path("flash_fwd")
    assert len({first, second, third}) == 3
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libflash_fwd-")


def test_sass_counts_reads_cuobjdump(monkeypatch):
    listing = "\n".join([
        "        /*0420*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0430*/  HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8] ;",
        "        /*0440*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "        /*0450*/  WARPGROUP.ARRIVE ;",
        "        /*0460*/  FFMA R1, R2, R3, R1 ;"])
    seen = {}

    def fake_run(cmd, **kwargs):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, stdout=listing)

    monkeypatch.setattr(_build, "nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    assert _build.sass_counts("flash_fwd") == {"HGMMA": 2, "HMMA": 1}
    assert seen["cmd"][:2] == ["/toolkit/bin/cuobjdump", "-sass"]


def test_sass_counts_by_function_splits_cuobjdump(monkeypatch):
    listing = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_122flash_bwd_dq_kernel_tcILi64EEEv",
        "        /*0420*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0430*/  HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8] ;",
        "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEv",
        "        /*0460*/  FFMA R1, R2, R3, R1 ;"])
    monkeypatch.setattr(_build, "nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(
        _build.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0, stdout=listing))
    assert _build.sass_counts_by_function("flash_bwd") == {
        "_ZN12_GLOBAL__N_122flash_bwd_dq_kernel_tcILi64EEEv":
            {"HGMMA": 2, "HMMA": 0},
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEv":
            {"HGMMA": 0, "HMMA": 0}}
