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

