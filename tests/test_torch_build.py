"""The kernel build keeps nvcc's output beside each library it builds, so
ptxas's report of a library built by an earlier process can still be read
(``build.build_log``), and ``chip_smoke.py``'s parser of that report
names template and plain kernels alike.  No nvcc runs here: the compiler
is a stand-in process object."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

LOG = """ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__8eb44dca_18_paged_attention_cu_ac50fdda17paged_wide_kernelEPK13__nv_bfloat16S2_S2_PKiS4_S4_PS0_PfPiiiiffi' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__8eb44dca_18_paged_attention_cu_ac50fdda17paged_wide_kernelEPK13__nv_bfloat16S2_S2_PKiS4_S4_PS0_PfPiiiiffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_ac50fdda19flash_fwd_tc_kernelILi256ELi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_ac50fdda19flash_fwd_tc_kernelILi256ELi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiifii
    400 bytes stack frame, 1172 bytes spill stores, 1168 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cumulative stack size
"""


class FakeNvcc:
    """What ``_finish`` reads of a finished nvcc process."""

    def __init__(self, out: str, returncode: int):
        self.out, self.returncode = out, returncode

    def communicate(self):
        return self.out, None


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "logs", {})
    return tmp_path


def test_finish_keeps_the_log_beside_the_library(build_dir, monkeypatch):
    name = build.sources()[0]
    lib = build.library_path(name)
    assert lib.parent == build_dir
    assert build.build_log(name) is None          # nothing built yet
    tmp = lib.with_suffix(".123.tmp")
    tmp.write_bytes(b"\x7fELF")
    build._finish(name, FakeNvcc(LOG, 0), tmp)
    assert lib.read_bytes() == b"\x7fELF" and not tmp.exists()
    assert lib.with_suffix(".log").read_text() == LOG
    assert build.build_log(name) == LOG
    # another process: nothing in memory, the kept log is read
    monkeypatch.setattr(build, "logs", {})
    assert build.build_log(name) == LOG
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


def test_failed_build_keeps_neither_library_nor_log(build_dir):
    name = build.sources()[0]
    lib = build.library_path(name)
    tmp = lib.with_suffix(".123.tmp")
    tmp.write_bytes(b"partial")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build._finish(name, FakeNvcc("error: boom", 1), tmp)
    assert list(build_dir.iterdir()) == []
    assert build.build_log(name) == "error: boom"   # this process saw it


def test_finish_of_a_library_already_built_reads_nothing(build_dir):
    """``_start`` hands back no process when the library exists; its log
    is then whatever the process that built it kept."""
    name = build.sources()[0]
    build.library_path(name).write_bytes(b"\x7fELF")
    assert build._start(name) == (None, None)
    build._finish(name, None, None)
    assert build.build_log(name) is None


def test_ptxas_summary_names_template_and_plain_kernels():
    insts = chip_smoke.ptxas_summary(LOG)
    assert insts == [("paged_wide_kernel", 80, 0, 0, 0),
                     ("flash_fwd_tc_kernel<Li256ELi64E>", 168, 0, 1172, 400)]
    strict = tuple(chip_smoke.STRICT_KERNELS)
    assert [i[0] for i in insts if i[0].startswith(strict)] == [
        "paged_wide_kernel", "flash_fwd_tc_kernel<Li256ELi64E>"]
    assert set(chip_smoke.STRICT_KERNELS.values()) <= set(build.sources())

