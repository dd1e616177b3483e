"""The port's kernel build (``repro_torch.kernels.build``) on the CPU, with a
stand-in for nvcc: the library's name follows its inputs, and the ``ptxas
-v`` report is kept beside the library, so a later process that finds the
library built still reports its registers and spills; the reports as the
build gate of ``chip_smoke.py`` reads them."""
import importlib.util
import stat
from pathlib import Path

import pytest

from repro_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
# writes the -o target and a ptxas-like report on stderr, as nvcc -Xptxas -v does
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
echo "ptxas info    : Used 42 registers, used 1 barriers" >&2
"""


@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "build_log", {})
    return csrc


def test_a_cached_library_still_reports_ptxas(fake_toolchain):
    first = build._build("k")
    log = build.build_log["k"]
    assert not log["cached"]
    assert log["ptxas"] == ["ptxas info    : Used 42 registers, used 1 barriers"]
    assert first.with_name(first.name + ".ptxas").exists()
    again = build._build("k")  # as a later process finds it
    assert again == first
    assert build.build_log["k"]["cached"] and build.build_log["k"]["ptxas"] == log["ptxas"]


def test_the_library_name_follows_the_headers(fake_toolchain):
    first = build._build("k")
    (fake_toolchain / "h.cuh").write_text("// header, changed\n")
    second = build._build("k")
    assert second != first and not build.build_log["k"]["cached"]


def test_every_kernel_source_is_listed():
    """``build.SOURCES`` names every ``csrc/*.cu``, so a run that builds the
    listed sources (``chip_smoke.py``) builds every kernel of the port."""
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.SOURCES)


# a ptxas -v report of flash attention's forward library, as nvcc prints it
# (the names mangled in the source's anonymous namespace): kernel name,
# registers, spill bytes
_PREFIX = "_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_2c138979"
FWD_KERNELS = (
    ("14flash_fwd_wideILi192ELi128EEEvNS_8WideMapsENS_6ParamsE", 230, 0),
    ("14flash_fwd_wideILi256ELi256EEEvNS_8WideMapsENS_6ParamsE", 242, 8),
    ("13flash_fwd_f32ILi192ELi128EEEvNS_6ParamsE", 128, 0),
    ("13flash_fwd_f32ILi256ELi256EEEvNS_6ParamsE", 128, 0),
    ("13flash_fwd_f32ILi64ELi64EEEvNS_6ParamsE", 80, 16),
    ("13flash_fwd_mmaILi128ELi128EEEvNS_6ParamsE", 207, 0),
    ("15flash_fwd_wgmmaENS_6ParamsE", 126, 0),
)


def _fwd_report() -> list:
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, regs, spill in FWD_KERNELS:
        lines += [f"ptxas info    : Compiling entry function '{_PREFIX}{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {_PREFIX}{name}",
                  f"0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return lines


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_build_gate_reads_k1s_four_wide_instantiations(monkeypatch):
    """``chip_smoke.py``'s build gate takes K1's bf16 and f32
    instantiations at 192/128 and 256/256, and no other, with their
    registers and spills (a spill there fails the build phase)."""
    monkeypatch.setattr(build, "build_log", {"flash_attention": {"ptxas": _fwd_report()},
                                             "flash_attention_bwd": {"ptxas": []}})
    wide = _chip_smoke()._wide_resources(build)
    assert wide["flash_attention_bwd"] == {}
    assert wide["flash_attention"] == {
        "flash_fwd_wide<192,128>": {"registers": 230, "spill_stores": 0, "spill_loads": 0},
        "flash_fwd_wide<256,256>": {"registers": 242, "spill_stores": 8, "spill_loads": 8},
        "flash_fwd_f32<192,128>": {"registers": 128, "spill_stores": 0, "spill_loads": 0},
        "flash_fwd_f32<256,256>": {"registers": 128, "spill_stores": 0, "spill_loads": 0},
    }



def _report(namespace: str, kernels) -> list:
    prefix = f"_ZN{len(namespace)}{namespace}"
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, regs, spill in kernels:
        lines += [f"ptxas info    : Compiling entry function '{prefix}{name}' for 'sm_90a'",
                  f"0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return lines


def test_the_build_gate_reads_the_128_128_instantiations(monkeypatch):
    """``chip_smoke.py``'s build gate at 128/128 takes K1's ``flash_fwd_wide``
    and ``flash_fwd_f32`` there and K1-bwd's seven (the preprocess, which
    192/128 shares, in both dtypes; f32 dK/dV and dQ; the bf16 two-warpgroup
    dK/dV, its reduce and dQ), and none at another pair."""
    fwd = (("14flash_fwd_wideILi128ELi128EEEvNS_8WideMapsENS_6ParamsE", 200, 0),
           ("13flash_fwd_f32ILi128ELi128EEEvNS_6ParamsE", 128, 0),
           ("14flash_fwd_wideILi192ELi128EEEvNS_8WideMapsENS_6ParamsE", 230, 0),
           ("15flash_fwd_wgmmaILi64EEEvNS_6ParamsE", 126, 0))
    bwd = (("14bwd_preprocessI13__nv_bfloat16Li128EEEvNS_6ParamsE", 30, 0),
           ("14bwd_preprocessIfLi128EEEvNS_6ParamsE", 30, 0),
           ("14bwd_preprocessIfLi64EEEvNS_6ParamsE", 30, 0),
           ("8bwd_dkdvILi128ELi128EEEvNS_6ParamsE", 128, 0),
           ("6bwd_dqILi128ELi128EEEvNS_6ParamsE", 128, 0),
           ("12bwd_dkdv_wg2ILi128ELi128EEEvNS_6ParamsE", 200, 0),
           ("15bwd_dkdv_reduceILi128ELi128EEEvNS_6ParamsE", 32, 0),
           ("9bwd_dq_wgILi128ELi128ELi2EEEvNS_6ParamsE", 180, 4),
           ("12bwd_dkdv_wg2ILi192ELi128EEEvNS_6ParamsE", 190, 0),
           ("12bwd_dkdv_mmaILi64ELi64ELb1EEEvNS_6ParamsE", 150, 0))
    monkeypatch.setattr(build, "build_log", {
        "flash_attention": {"ptxas": _report("_GLOBAL__N__04cf38d3_18_flash_attention_cu_2c138979",
                                             fwd)},
        "flash_attention_bwd": {"ptxas": _report(
            "_GLOBAL__N__5e1f7a20_22_flash_attention_bwd_cu_9d0b4c11", bwd)}})
    got = _chip_smoke()._dh128_resources(build)
    assert got["flash_attention"] == {
        "flash_fwd_wide<128,128>": {"registers": 200, "spill_stores": 0, "spill_loads": 0},
        "flash_fwd_f32<128,128>": {"registers": 128, "spill_stores": 0, "spill_loads": 0},
    }
    assert sorted(got["flash_attention_bwd"]) == sorted([
        "bwd_preprocess<bf16,128>", "bwd_preprocess<float,128>", "bwd_dkdv<128,128>",
        "bwd_dq<128,128>", "bwd_dkdv_wg2<128,128>", "bwd_dkdv_reduce<128,128>",
        "bwd_dq_wg<128,128,2>"])
    assert got["flash_attention_bwd"]["bwd_dq_wg<128,128,2>"]["spill_stores"] == 4
