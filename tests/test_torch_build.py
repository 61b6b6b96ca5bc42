"""The port's kernel build helpers (mafed_tpu_torch/kernels/build.py) on the CPU:
the library's name follows every source file, and the ptxas report is read
per kernel. Nothing here compiles."""

from mafed_tpu_torch.kernels import build

PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 93 registers, used 1 barriers, 896 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi64EEEv14CUtensorMap_st
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_library_name_follows_every_source_file(tmp_path, monkeypatch):
    (tmp_path / "flash_attn.cu").write_text('#include "sm90.cuh"\n')
    header = tmp_path / "sm90.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path()
    assert first == build.library_path()
    header.write_text("// v2\n")
    assert build.library_path() != first


def test_kernel_resources_reads_the_ptxas_report():
    assert build.kernel_resources(PTXAS) == {
        "flash_fwd_kernel": {"spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 93},
        "flash_bwd_dkv_kernel": {"spill_store_bytes": 8, "spill_load_bytes": 16, "registers": 255},
    }
