"""The port's kernel build (``repro_torch.kernels.build``) on the CPU, with a
stand-in for nvcc: the library's name follows its inputs, and the ``ptxas
-v`` report is kept beside the library, so a later process that finds the
library built still reports its registers and spills."""
import stat

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
