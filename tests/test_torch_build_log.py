"""What ``nvcc`` printed is kept beside each library it built.

``kernels/build.py`` reuses a library whose source and flags are unchanged;
ptxas's report of registers and spills (``-Xptxas -v``) is written beside
it, so a reused library reports them as a fresh build does, and a library
without its report is built again.  ``chip_smoke.py``'s build phase reads
that report, prints it and fails when an fp32 flash instance is missing
from it or spills: on a cached build as on a fresh one.

No nvcc here: a stand-in writes an empty library and prints a report in
ptxas's format, with names mangled as nvcc mangles a kernel in an
anonymous namespace.
"""

import importlib.util
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_for_build_log", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

F32_REGS = {64: 186, 128: 215, 192: 200, 256: 237}


def _report(source, kernels):
    """ptxas -v's lines for ``kernels``: (name, template integers,
    registers, spill store bytes, spill load bytes)."""
    lines = []
    for name, args, regs, stores, loads in kernels:
        mangled = (f"_ZN37_INTERNAL_1a2b3c4d_{len(source) + 3}_{source}_cu_9f8e7d6c"
                   f"{len(name)}{name}I{''.join(f'Li{a}E' for a in args)}EEvNS_6ParamsE")
        lines += [f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {mangled}",
                  f"    {stores} bytes stack frame, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers, 384 bytes cmem[0]"]
    return "\n".join(lines) + "\n"


def _flash_kernels(spill_at=None, drop=None):
    return ([("fa_fwd_bf16", (64, 2), 125, 0, 0), ("fa_fwd_bf16", (128, 1), 178, 0, 0)]
            + [("fa_fwd_f32", (d,), r, 20 if d == spill_at else 0, 20 if d == spill_at else 0)
               for d, r in F32_REGS.items() if d != drop])


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """build.py over a build directory of its own and a stand-in nvcc that
    logs its calls; returns (calls file, reports directory)."""
    reports, calls = tmp_path / "reports", tmp_path / "calls"
    reports.mkdir()
    for name in build.sources():
        kernels = _flash_kernels() if name == "flash_attention" else [(f"{name}_k", (64,), 96, 0, 0)]
        (reports / f"{name}.txt").write_text(_report(name, kernels))
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\nfrom pathlib import Path\n"
        "out, src = Path(sys.argv[sys.argv.index('-o') + 1]), Path(sys.argv[-1])\n"
        f"with open({str(calls)!r}, 'a') as f:\n    f.write(src.stem + '\\n')\n"
        "out.write_bytes(b'')\n"
        f"print(Path({str(reports)!r}, src.stem + '.txt').read_text(), end='')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "ptxas_log", {})
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return calls, reports


def _calls(calls):
    return sorted(calls.read_text().split()) if calls.exists() else []


def _no_nvcc(monkeypatch):
    def refuse():
        raise AssertionError("nvcc called for a library that was built")
    monkeypatch.setattr(build, "_nvcc", refuse)
    monkeypatch.setattr(build, "ptxas_log", {})


def test_the_report_is_kept_and_read_back_for_a_reused_library(stand_in, monkeypatch):
    calls, _ = stand_in
    targets = build.build_all()
    assert _calls(calls) == sorted(build.sources())
    fresh = dict(build.ptxas_log)
    for name, target in targets.items():
        assert target.exists() and target.with_suffix(".log").read_text() == fresh[name]
    _no_nvcc(monkeypatch)
    assert build.build_all() == targets
    assert build.ptxas_log == fresh


def test_a_library_without_its_report_is_built_again(stand_in):
    calls, _ = stand_in
    targets = build.build_all()
    targets["flash_attention"].with_suffix(".log").unlink()
    build.ptxas_log.clear()
    build.build_all()
    assert _calls(calls) == sorted(list(build.sources()) + ["flash_attention"])
    assert "fa_fwd_f32" in build.ptxas_log["flash_attention"]
    assert set(build.ptxas_log) == set(build.sources())


def test_the_build_phase_reports_every_fp32_instance_from_a_cached_build(stand_in, monkeypatch):
    build.build_all()
    _no_nvcc(monkeypatch)
    ptxas = cs.phase_build()
    f32 = {k: v for k, v in ptxas["flash_attention"].items() if k.startswith("fa_fwd_f32")}
    assert f32 == {f"fa_fwd_f32<{d}>": [F32_REGS[d], 0, 0] for d in fa._HEAD_DIMS}
    assert ptxas["flash_attention"]["fa_fwd_bf16<64, 2>"] == [125, 0, 0]


@pytest.mark.parametrize("fault", ["spill", "missing"])
def test_the_build_phase_rejects_a_spill_or_a_missing_fp32_instance(stand_in, monkeypatch,
                                                                     fault):
    _, reports = stand_in
    kernels = _flash_kernels(spill_at=256) if fault == "spill" else _flash_kernels(drop=192)
    (reports / "flash_attention.txt").write_text(_report("flash_attention", kernels))
    build.build_all()
    _no_nvcc(monkeypatch)
    match = "spills" if fault == "spill" else "fa_fwd_f32<192>"
    with pytest.raises(AssertionError, match=match):
        cs.phase_build()
