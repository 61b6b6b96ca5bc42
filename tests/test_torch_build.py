"""The port's kernel build helpers (mafed_tpu_torch/kernels/build.py) on the CPU:
the library's name follows every source file, and the ptxas report and the
SASS dump are read per instantiation (kernel and head_dim; a wide kernel and
its slice width). Nothing here compiles."""

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

# nvcc's report of a library with every head_dim of all three kernels and the
# three wide kernels, the instantiations of a kernel in a different order for
# each kernel (ptxas orders entries by neither kernel nor head_dim): each
# kernel's warpgroups (the *_WG_* of flash_attn.cu) and its registers as
# ptxas read them for sm_90a on an H100, with a spill made up at dK/dV 256 so
# that one is read. A wide kernel has one template argument, the width of its
# output slice (128), and takes head_dim at run time.
_MANGLED = "_ZN12_GLOBAL__N_1{n}{name}ILi{d}ELi{wg}EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16Pfiiiif"
_MANGLED_WIDE = "_ZN12_GLOBAL__N_1{n}{name}ILi{d}EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16Pfiiiiif"
_ENTRIES = [("flash_fwd_kernel", 64, 1, 92, 0), ("flash_fwd_kernel", 96, 2, 100, 0),
            ("flash_fwd_kernel", 128, 1, 128, 0), ("flash_fwd_kernel", 256, 2, 128, 0),
            ("flash_bwd_dkv_kernel", 256, 2, 234, 24), ("flash_bwd_dkv_kernel", 128, 1, 234, 0),
            ("flash_bwd_dkv_kernel", 96, 1, 234, 0), ("flash_bwd_dkv_kernel", 64, 1, 163, 0),
            ("flash_bwd_dq_kernel", 128, 1, 154, 0), ("flash_bwd_dq_kernel", 64, 1, 122, 0),
            ("flash_bwd_dq_kernel", 256, 1, 218, 0), ("flash_bwd_dq_kernel", 96, 1, 154, 0),
            ("flash_bwd_dq_wide_kernel", 128, None, 177, 0), ("flash_fwd_wide_kernel", 128, None, 140, 0),
            ("flash_bwd_dkv_wide_kernel", 128, None, 243, 0)]

def _mangled(name, d, wg):
    if wg is None:
        return _MANGLED_WIDE.format(n=len(name), name=name, d=d)
    return _MANGLED.format(n=len(name), name=name, d=d, wg=wg)


PTXAS_BOTH = "".join(
    f"ptxas info    : Compiling entry function '{_mangled(name, d, wg)}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {_mangled(name, d, wg)}\n"
    f"    0 bytes stack frame, {spill} bytes spill stores, {spill // 2} bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, used 1 barriers, 944 bytes cmem[0]\n"
    for name, d, wg, regs, spill in _ENTRIES
)

SASS_BOTH = "".join(
    f"\n\tcode for sm_90a\n\t\tFunction : {_mangled(name, d, wg)}\n"
    "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"\n"
    + "        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;\n" * -(-d // 64)
    + "        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;\n" * (d // 16 + regs % 7)
    + "        /*0300*/                   EXIT ;\n"
    for name, d, wg, regs, _ in _ENTRIES
)


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
        "flash_fwd_kernel<64>": {"spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 93},
        "flash_bwd_dkv_kernel<64>": {"spill_store_bytes": 8, "spill_load_bytes": 16, "registers": 255},
    }


def test_kernel_resources_keeps_every_instantiation_apart():
    got = build.kernel_resources(PTXAS_BOTH)
    assert sorted(got) == sorted(build.INSTANTIATIONS) and len(got) == 15
    for name, d, _, regs, spill in _ENTRIES:
        assert got[build.instantiation(name, d)] == {
            "spill_store_bytes": spill, "spill_load_bytes": spill // 2, "registers": regs}


def test_sass_counts_keep_every_instantiation_apart():
    got = build.parse_sass(SASS_BOTH)
    assert sorted(got) == sorted(build.INSTANTIATIONS)
    for name, d, _, regs, _ in _ENTRIES:
        assert got[build.instantiation(name, d)] == {"UTMALDG": -(-d // 64), "HGMMA": d // 16 + regs % 7}


def test_the_wide_kernels_are_instantiations_of_their_own():
    """The three wide kernels are reported under their own names, at their
    slice width, beside the twelve fixed instantiations."""
    wide = [build.instantiation(k, build.WIDE_SLICE) for k in build.WIDE_KERNELS]
    assert wide == ["flash_fwd_wide_kernel<128>", "flash_bwd_dkv_wide_kernel<128>", "flash_bwd_dq_wide_kernel<128>"]
    assert build.INSTANTIATIONS[-3:] == tuple(wide) and len(set(build.INSTANTIATIONS)) == 15
    assert build._kernel_of(_mangled("flash_fwd_wide_kernel", 128, None)) == "flash_fwd_wide_kernel<128>"
    assert build._kernel_of(_mangled("flash_fwd_kernel", 256, 2)) == "flash_fwd_kernel<256>"


def test_the_launchers_take_every_multiple_of_128_from_384():
    assert [d for d in range(16, 2049, 16) if build.takes_head_dim(d)] == (
        [64, 96, 128, 256] + list(range(384, 2049, 128)))
    assert [d for d in range(16, 2049, 16) if build.wide_head_dim(d)] == list(range(384, 2049, 128))
