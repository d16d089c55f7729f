"""The port's Hopper kernel certifier (``mpi4dl_tpu_torch/analysis/
pallascheck``): the ptxas parser on a report of the card's build, each
resource finding injected beside a clean kernel, the NaN canary on CPU
stand-ins for a registry row, the exit-2 path with no ptxas report, and
``kernels.json`` covering every ``KernelCase.kernel``.  The certifier
itself runs on the card (``chip_smoke.py``'s ``phase_kernelcheck``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from mpi4dl_tpu_torch.analysis.__main__ import main as analysis_main
from mpi4dl_tpu_torch.analysis.pallascheck import FINDING_KINDS, resource_findings
from mpi4dl_tpu_torch.analysis.pallascheck.resources import (
    SMEM_PER_BLOCK, demangle, name_key, parse_ptxas, resource_problems,
)
from mpi4dl_tpu_torch.analysis.pallascheck.sanitize import NOT_RUN, canary
from mpi4dl_tpu_torch.ops.kernel_registry import enrolled_kernels

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "mpi4dl_tpu_torch", "analysis", "contracts", "goldens")

# Four entries of ptxas's report of the card's build (H100 machine, CUDA 12.9).
REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__2939eb44_12_halo_conv_cu_9d7a0bf42tc16halo_conv_kernelILi2ELi2ELi2ELi2ELi2ELi8EfEEvPK13__nv_bfloat16S4_PT5_PfS7_iiiiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__2939eb44_12_halo_conv_cu_9d7a0bf42tc16halo_conv_kernelILi2ELi2ELi2ELi2ELi2ELi8EfEEvPK13__nv_bfloat16S4_PT5_PfS7_iiiiiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 77 registers, used 1 barriers
ptxas info    : Compile time = 131.210 ms
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__2939eb44_12_halo_conv_cu_9d7a0bf44simt16halo_conv_kernelIfEEvPKfS3_PT_PfS6_iiiiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__2939eb44_12_halo_conv_cu_9d7a0bf44simt16halo_conv_kernelIfEEvPKfS3_PT_PfS6_iiiiiiiiiiii
    8 bytes stack frame, 8 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size, 16640 bytes smem
ptxas info    : Compile time = 159.678 ms
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__2c41a9bd_14_block_flash_cu_2150192e2tc22block_flash_fwd_kernelILi8ELi4EEEvPK13__nv_bfloat16S4_S4_PfS5_S5_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__2c41a9bd_14_block_flash_cu_2150192e2tc22block_flash_fwd_kernelILi8ELi4EEEvPK13__nv_bfloat16S4_S4_PfS5_S5_iiiiiif
    24 bytes stack frame, 64 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compile time = 374.535 ms
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__2c41a9bd_14_block_flash_cu_2150192e2tc24block_flash_split_kernelEPKfP13__nv_bfloat16S4_x' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__2c41a9bd_14_block_flash_cu_2150192e2tc24block_flash_split_kernelEPKfP13__nv_bfloat16S4_x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
ptxas info    : Compile time = 5.287 ms
"""


def _parsed():
    return {name_key(demangle(sym)): res for sym, res in parse_ptxas(REPORT).items()}


def test_ptxas_parser_on_the_cards_report():
    got = _parsed()
    assert got == {
        "{anon}::tc::halo_conv_kernel<2,2,2,2,2,8,float>": dict(
            regs=77, stack=0, spill_stores=0, spill_loads=0, smem_static=0),
        "{anon}::simt::halo_conv_kernel<float>": dict(
            regs=80, stack=8, spill_stores=8, spill_loads=24, smem_static=16640),
        "{anon}::tc::block_flash_fwd_kernel<8,4>": dict(
            regs=255, stack=24, spill_stores=64, spill_loads=44, smem_static=0),
        "{anon}::tc::block_flash_split_kernel": dict(
            regs=16, stack=0, spill_stores=0, spill_loads=0, smem_static=0),
    }


def test_name_key_joins_ptxas_and_profiler_names():
    profiler = ("void (anonymous namespace)::tc::halo_conv_kernel<2, 2, 2, 2, 2, 8, float>"
                "(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, float*, float*, int, "
                "int, int, int, int, int, int, int, int, int, int, int)")
    assert name_key(profiler) in _parsed()


CLEAN = dict(regs=77, stack=0, spill_stores=0, spill_loads=0, smem_static=0,
             smem_dynamic=48 * 1024, threads=256, min_blocks=2, blocks_per_sm=2)
INJECTED = {
    "smem-overbudget": dict(smem_dynamic=SMEM_PER_BLOCK, min_blocks=1),
    "register-spill": dict(stack=8, spill_stores=8, spill_loads=24),
    "launch-bounds-unmet": dict(regs=168, threads=256, min_blocks=2),
}


@pytest.mark.parametrize("kind", sorted(INJECTED))
def test_resource_kind_injected(kind):
    assert resource_problems(CLEAN) == []
    res = {**CLEAN, **INJECTED[kind], "smem_static": 1024 if kind == "smem-overbudget" else 0}
    assert [k for k, _ in resource_problems(res)] == [kind]


def test_launch_bounds_shared_memory_and_smem_frac():
    res = {**CLEAN, "smem_dynamic": 120 * 1024}  # two blocks need 240 KiB of 228
    assert [k for k, _ in resource_problems(res)] == ["launch-bounds-unmet"]
    assert [k for k, _ in resource_problems({**CLEAN, "min_blocks": 0,
                                             "smem_dynamic": 120 * 1024})] == []
    assert [k for k, _ in resource_problems(CLEAN, smem_frac=0.2)] == ["smem-overbudget"]
    found = resource_findings({"s": {**CLEAN, **INJECTED["register-spill"], "name": "k<1>"}},
                              "halo_conv2d:float32")
    assert [f.key for f in found] == ["k<1>:halo_conv2d:float32:register-spill"]


class _Row:
    """A CPU stand-in for a registry row whose call writes ``part`` of its
    output."""

    kernel = "fake"
    name = "fake:float32"

    def __init__(self, part):
        self.part = part

    def build(self, device):
        def call(x):
            y = torch.empty(x.shape, dtype=x.dtype, device=device)
            y[: self.part] = x[: self.part] * 2
            return y, torch.empty(0)

        x = torch.ones(8, device=device)
        return call, call, (x,)


def test_untiled_output_canary():
    assert canary(_Row(8), "cpu") == []
    (msg,) = canary(_Row(5), "cpu")
    assert "3 of 8 elements never written" in msg


def test_no_ptxas_report_exits_2(capsys):
    assert analysis_main(["pallascheck"]) == 2
    assert "build the kernels on a machine with nvcc" in capsys.readouterr().err
    assert analysis_main(["pallascheck", "--require-smem-frac", "1.5"]) == 2
    assert analysis_main(["pallascheck", "--kernels", "nope"]) == 2


def test_kinds_and_not_run():
    assert set(FINDING_KINDS) == {"smem-overbudget", "register-spill",
                                  "launch-bounds-unmet", "untiled-output"}
    assert set(NOT_RUN) == {"oob-access", "smem-race", "uninit-read", "barrier-hazard"}


def test_kernels_golden_covers_every_registry_kernel():
    with open(os.path.join(GOLDENS, "kernels.json"), encoding="utf-8") as fh:
        contract = json.load(fh)
    assert set(enrolled_kernels()) <= set(contract["kernels"])
    for kernel, symbols in contract["kernels"].items():
        assert symbols and set(symbols) <= set(contract["symbols"]), kernel
    for sym in contract["symbols"].values():
        assert {"regs", "stack", "spill_stores", "spill_loads", "smem_static",
                "smem_dynamic", "threads", "min_blocks", "blocks_per_sm"} <= set(sym)


def test_case_symbols_are_the_launch_logs(monkeypatch):
    from mpi4dl_tpu_torch.analysis import pallascheck
    from mpi4dl_tpu_torch.analysis.pallascheck import sanitize

    resources = {"_Z1av": {**CLEAN, "name": "a"}, "_Z1bv": {**CLEAN, "name": "b"}}
    for launched, want in (({"_Z1bv"}, ["_Z1bv"]), ({"_Z1av", "_Z1bv"}, ["_Z1av", "_Z1bv"]),
                           (set(), "launched none"), ({"_Z1cv"}, "no ptxas report")):
        monkeypatch.setattr(sanitize, "launched_symbols", lambda case, got=launched: got)
        if isinstance(want, str):
            with pytest.raises(pallascheck.EnvironmentProblem, match=want):
                pallascheck.case_symbols(_Row(8), resources)
        else:
            assert sorted(pallascheck.case_symbols(_Row(8), resources)) == want
