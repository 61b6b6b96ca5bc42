"""The port's kernel build helpers (mafed_tpu_torch/kernels/build.py) on the CPU:
the library's name follows every source file, and the ptxas report and the
SASS dump are read per instantiation (kernel and head_dim; a wide kernel and
its width, the most output columns of a CTA; a float32 kernel and its slice
width), and the SASS check asks TMA loads and wgmma of the bfloat16 kernels
and TF32 mma.sync (the 3xTF32 products) without wgmma of the float32
kernels, the forward's two instantiations among them. Nothing here
compiles."""

import re

import pytest

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

# nvcc's report of a library with every head_dim of all three kernels, the
# three wide kernels and the three float32 kernels, the instantiations of a
# kernel in a different order for each kernel (ptxas orders entries by neither
# kernel nor head_dim): each kernel's warpgroups (the *_WG_* of flash_attn.cu)
# and its registers as ptxas read them for sm_90a on an H100, with a spill made
# up at dK/dV 256 so that one is read. A wide kernel has one template argument,
# the most output columns of one CTA (the forward's piece of 512, dK/dV's and
# dQ's slice of 128), and takes head_dim at run time; so does
# a float32 kernel (wg "f32" below: its mangled name takes float pointers),
# whose forward is built at four slice widths (64, 96, 128 and 512). The
# bf16 forward at 96, 128 and 256 takes two warpgroups a CTA, each with its own
# query tile (at 96 unpadded tiles of three 32-column boxes, as dK/dV at 96).
_MANGLED = "_ZN12_GLOBAL__N_1{n}{name}ILi{d}ELi{wg}EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16Pfiiiif"
_MANGLED_WIDE = "_ZN12_GLOBAL__N_1{n}{name}ILi{d}EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16Pfiiiiif"
_MANGLED_F32 = "_ZN12_GLOBAL__N_1{n}{name}ILi{d}EEEvPKfS2_S2_PKiPfS5_iiiiiif"
_ENTRIES = [("flash_fwd_kernel", 64, 1, 92, 0), ("flash_fwd_kernel", 96, 2, 121, 0),
            ("flash_fwd_kernel", 128, 2, 128, 0), ("flash_fwd_kernel", 256, 2, 195, 0),
            ("flash_bwd_dkv_kernel", 256, 2, 192, 24), ("flash_bwd_dkv_kernel", 128, 1, 234, 0),
            ("flash_bwd_dkv_kernel", 96, 1, 200, 0), ("flash_bwd_dkv_kernel", 64, 1, 163, 0),
            ("flash_bwd_dq_kernel", 128, 1, 154, 0), ("flash_bwd_dq_kernel", 64, 1, 122, 0),
            ("flash_bwd_dq_kernel", 256, 1, 218, 0), ("flash_bwd_dq_kernel", 96, 1, 154, 0),
            ("flash_bwd_dq_wide_kernel", 128, None, 177, 0), ("flash_fwd_wide_kernel", 512, None, 128, 0),
            ("flash_bwd_dkv_wide_kernel", 128, None, 243, 0), ("flash_bwd_dq_f32_kernel", 128, "f32", 155, 0),
            ("flash_bwd_dkv_f32_kernel", 128, "f32", 192, 0), ("flash_fwd_f32_kernel", 128, "f32", 115, 0),
            ("flash_fwd_f32_kernel", 512, "f32", 127, 0), ("flash_fwd_f32_kernel", 96, "f32", 63, 0),
            ("flash_fwd_f32_kernel", 64, "f32", 64, 0)]

def _mangled(name, d, wg):
    if wg is None:
        return _MANGLED_WIDE.format(n=len(name), name=name, d=d)
    if wg == "f32":
        return _MANGLED_F32.format(n=len(name), name=name, d=d)
    return _MANGLED.format(n=len(name), name=name, d=d, wg=wg)


PTXAS_BOTH = "".join(
    f"ptxas info    : Compiling entry function '{_mangled(name, d, wg)}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {_mangled(name, d, wg)}\n"
    f"    0 bytes stack frame, {spill} bytes spill stores, {spill // 2} bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, used 1 barriers, 944 bytes cmem[0]\n"
    for name, d, wg, regs, spill in _ENTRIES
)

_HMMA_TF32 = "        /*0500*/                   HMMA.1688.F32.TF32 R4, R16, R20, R4 ;\n"


def _boxes(name, d):
    """TMA boxes a tile of a bfloat16 kernel's canned SASS: 64-column boxes,
    32-column ones for the forward and dK/dV at 96."""
    return d // 32 if (name, d) in (("flash_fwd_kernel", 96), ("flash_bwd_dkv_kernel", 96)) else -(-d // 64)


def _hmma_count(name, regs):
    """The TF32 HMMAs of a float32 kernel's canned SASS."""
    return regs % 5 + 3


def _sass_of(name, d, wg, regs, hgmma=True, hmma=True):
    """A function's SASS: a bfloat16 kernel's TMA loads and wgmma; a float32
    kernel's FFMAs and its 3xTF32 mma.sync (HMMA.1688.F32.TF32; with `hmma`
    False none); with `hgmma`, also a wgmma of the bfloat16 kind."""
    head = (f"\n\tcode for sm_90a\n\t\tFunction : {_mangled(name, d, wg)}\n"
            "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"\n")
    if wg == "f32":
        body = "        /*0400*/                   FFMA R12, R40, R52, R12 ;\n" * (regs % 11 + 1)
        n_hmma = _hmma_count(name, regs)
        body += _HMMA_TF32 * (n_hmma if hmma else 0)
        body += "        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;\n" * hgmma
    else:
        body = ("        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;\n" * _boxes(name, d)
                + "        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;\n"
                * (d // 16 + regs % 7))
    return head + body + "        /*0300*/                   EXIT ;\n"


SASS_BOTH = "".join(_sass_of(name, d, wg, regs, hgmma=False) for name, d, wg, regs, _ in _ENTRIES)


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
    assert sorted(got) == sorted(build.INSTANTIATIONS) and len(got) == 21
    for name, d, _, regs, spill in _ENTRIES:
        assert got[build.instantiation(name, d)] == {
            "spill_store_bytes": spill, "spill_load_bytes": spill // 2, "registers": regs}


def test_sass_counts_keep_every_instantiation_apart():
    got = build.parse_sass(SASS_BOTH)
    assert sorted(got) == sorted(build.INSTANTIATIONS)
    for name, d, wg, regs, _ in _ENTRIES:
        hmma = _hmma_count(name, regs) if wg == "f32" else 0
        want = ({"UTMALDG": 0, "HGMMA": 0, "FFMA": regs % 11 + 1} if wg == "f32" else
                {"UTMALDG": _boxes(name, d), "HGMMA": d // 16 + regs % 7, "FFMA": 0})
        assert got[build.instantiation(name, d)] == {**want, "HMMA": hmma, "HMMA.TF32": hmma}


def test_the_wide_kernels_are_instantiations_of_their_own():
    """The three wide kernels are reported under their own names, at their
    width (the forward's piece of up to 512 output columns a CTA, dK/dV's and
    dQ's slice of 128), beside the twelve fixed instantiations."""
    wide = [build.instantiation(k, build.wide_width(k)) for k in build.WIDE_KERNELS]
    assert wide == ["flash_fwd_wide_kernel<512>", "flash_bwd_dkv_wide_kernel<128>", "flash_bwd_dq_wide_kernel<128>"]
    assert build.BF16_INSTANTIATIONS[-3:] == tuple(wide) and len(set(build.BF16_INSTANTIATIONS)) == 15
    assert build._kernel_of(_mangled("flash_fwd_wide_kernel", 512, None)) == "flash_fwd_wide_kernel<512>"
    assert build._kernel_of(_mangled("flash_fwd_kernel", 256, 2)) == "flash_fwd_kernel<256>"


def test_the_launchers_take_every_multiple_of_128_from_384():
    assert [d for d in range(16, 2049, 16) if build.takes_head_dim(d)] == (
        [64, 96, 128, 256] + list(range(384, 2049, 128)))
    assert [d for d in range(16, 2049, 16) if build.wide_head_dim(d)] == list(range(384, 2049, 128))


def test_the_f32_kernels_are_a_group_of_their_own():
    """The three float32 kernels are reported under their own names, at their
    slice width (the forward at 64, 96, 128 and 512), after the fifteen
    bfloat16 instantiations; their mangled names are not taken for a
    bfloat16 kernel's."""
    assert build.F32_INSTANTIATIONS == (
        "flash_fwd_f32_kernel<64>", "flash_fwd_f32_kernel<96>", "flash_fwd_f32_kernel<128>",
        "flash_fwd_f32_kernel<512>", "flash_bwd_dkv_f32_kernel<128>", "flash_bwd_dq_f32_kernel<128>")
    assert build.INSTANTIATIONS == build.BF16_INSTANTIATIONS + build.F32_INSTANTIATIONS
    assert len(set(build.INSTANTIATIONS)) == 21
    for name in build.F32_KERNELS:
        assert build._kernel_of(_mangled(name, 128, "f32")) == f"{name}<128>"
    for width in (64, 96, 512):
        assert build._kernel_of(_mangled("flash_fwd_f32_kernel", width, "f32")) == f"flash_fwd_f32_kernel<{width}>"


def test_sass_check_asks_wgmma_of_bf16_and_ffma_without_wgmma_of_f32():
    """sass_faults over a canned `cuobjdump -sass` dump: none for the whole
    library as built; each instantiation judged by its own rule: a bfloat16
    kernel without HGMMA or UTMALDG, a float32 kernel with an HGMMA (a wgmma
    product), without HMMA (products on the CUDA cores: the float32 forward
    before its 3xTF32 form) or with an HMMA of another kind than TF32, at
    each of the forward's instantiations, and a missing instantiation are
    each named. (The name is the test's first one, from when the float32
    forward was an FFMA kernel.)"""
    assert build.sass_faults(build.parse_sass(SASS_BOTH)) == []
    entries = {build.instantiation(name, d): (name, d, wg, regs) for name, d, wg, regs, _ in _ENTRIES}

    def faults(replace):
        text = "".join(replace.get(key, _sass_of(*entry, hgmma=False)) for key, entry in entries.items())
        return build.sass_faults(build.parse_sass(text))

    def counts(hgmma=0, utmaldg=0, ffma=0, hmma=0, tf32=None):
        return {"HGMMA": hgmma, "UTMALDG": utmaldg, "FFMA": ffma, "HMMA": hmma,
                "HMMA.TF32": hmma if tf32 is None else tf32}

    no_tma = _sass_of(*entries["flash_fwd_kernel<96>"], hgmma=False).replace("UTMALDG", "LDG")
    assert faults({"flash_fwd_kernel<96>": no_tma}) == [
        f"flash_fwd_kernel<96>: needs HGMMA and UTMALDG, has {counts(hgmma=8)}"]
    key = "flash_bwd_dq_f32_kernel<128>"
    assert faults({key: _sass_of(*entries[key], hgmma=True)}) == [
        f"{key}: needs HMMA of the TF32 kind only and no HGMMA, has {counts(hgmma=1, ffma=2, hmma=3)}"]
    assert faults({key: _sass_of(*entries[key], hgmma=False, hmma=False)}) == [
        f"{key}: needs HMMA of the TF32 kind only and no HGMMA, has {counts(ffma=2)}"]
    key = "flash_bwd_dkv_f32_kernel<128>"
    other_kind = _sass_of(*entries[key], hgmma=False).replace("F32.TF32", "F32.BF16", 1)
    assert faults({key: other_kind}) == [
        f"{key}: needs HMMA of the TF32 kind only and no HGMMA, has {counts(ffma=6, hmma=5, tf32=4)}"]
    key = "flash_fwd_f32_kernel<64>"
    assert faults({key: _sass_of(*entries[key], hgmma=False, hmma=False)}) == [
        f"{key}: needs HMMA of the TF32 kind only and no HGMMA, has {counts(ffma=10)}"]
    key = "flash_fwd_f32_kernel<512>"
    assert faults({key: _sass_of(*entries[key], hgmma=True)}) == [
        f"{key}: needs HMMA of the TF32 kind only and no HGMMA, has {counts(hgmma=1, ffma=7, hmma=5)}"]
    assert faults({"flash_bwd_dkv_f32_kernel<128>": ""}) == ["flash_bwd_dkv_f32_kernel<128>: not in the SASS"]


# (head_dim, bf16 CTAs a tile of the forward and of dK/dV and dQ, the bf16 forward's instantiation and the
# backward kernels' width)
ROUTE_CASES = [(64, (1, 1), "flash_fwd_kernel<64>", 64), (96, (1, 1), "flash_fwd_kernel<96>", 96),
               (128, (1, 1), "flash_fwd_kernel<128>", 128), (256, (1, 1), "flash_fwd_kernel<256>", 256),
               (384, (1, 3), "flash_fwd_wide_kernel<512>", 128), (512, (1, 4), "flash_fwd_wide_kernel<512>", 128),
               (640, (2, 5), "flash_fwd_wide_kernel<512>", 128)]


@pytest.mark.parametrize("head_dim,bf16_slices,bf16_kernel,bwd_width", ROUTE_CASES)
def test_route_names_the_entry_kernel_and_slices(head_dim, bf16_slices, bf16_kernel, bwd_width):
    """At every head_dim the JAX dispatcher sends to Pallas: bfloat16 to the
    kernel of its head_dim (one CTA a tile) or a wide kernel: the forward's
    <512> in ceil(head_dim / 512) pieces, dK/dV's and dQ's <128> in
    head_dim / 128 slices; float32 to the float32 kernels: the backward pair
    at ceil(head_dim / 128) slices, the forward at one slice up to 512
    columns (its instantiation of head_dim 64, 96 or 128; its <512> above:
    ceil(head_dim / 512))."""
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        bf16 = build.route(name, "bfloat16", head_dim)
        fwd = name == "flash_fwd"
        kernel = bf16_kernel if fwd else re.sub(r"<\d+>", f"<{bwd_width}>", bf16_kernel.replace("flash_fwd", name))
        assert (bf16.entry, bf16.instantiation, bf16.slices) == (
            build.ENTRY_POINTS[name], kernel, bf16_slices[0 if fwd else 1])
        width = (head_dim if head_dim <= 128 else 512) if fwd else 128
        f32 = build.route(name, "float32", head_dim)
        assert (f32.entry, f32.instantiation, f32.slices) == (
            build.ENTRY_POINTS[name] + "_f32", f"{name}_f32_kernel<{width}>", -(-head_dim // width))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        build.route("flash_fwd", "float16", head_dim)
    with pytest.raises(ValueError, match="head_dim 320"):
        build.route("flash_fwd", "float32", 320)


def test_compare_sass_reads_each_instantiation_apart_from_library_wide_text():
    """scripts/compare_sass.py: a function's SASS is keyed by instantiation and
    compared without what the dump sets across the library (label numbers,
    column padding, blank lines, the next ELF image's header), so one kernel
    more or another kernel order leaves the others the same; a changed
    instruction is not."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "compare_sass.py"
    spec = importlib.util.spec_from_file_location("compare_sass", path)
    compare_sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(compare_sass)
    body = ("        /*0000*/                   BRA `(.L_x_{a}) ;{pad}   /* 0x0 */\n"
            ".L_x_{a}:\n        /*0010*/                   BRA `(.L_x_{b}) ;\n.L_x_{b}:\n")
    head = "\t\tFunction : {}\n"
    one = (head.format(_mangled("flash_fwd_kernel", 64, 1)) + body.format(a=3, b=4, pad="")
           + head.format(_mangled("flash_bwd_dq_kernel", 64, 1)) + body.format(a=5, b=6, pad="")
           + "\nFatbin elf code:\n================\narch = sm_90a\n")
    two = (head.format(_mangled("flash_bwd_dq_kernel", 64, 1)) + body.format(a=0, b=1, pad="  ")
           + head.format(_mangled("flash_fwd_kernel", 64, 1)) + body.format(a=7, b=9, pad="  "))
    here, there = compare_sass.functions(one), compare_sass.functions(two)
    assert sorted(here) == ["flash_bwd_dq_kernel<64>", "flash_fwd_kernel<64>"] and here == there
    changed = compare_sass.functions(two.replace("BRA `(.L_x_9)", "BRA `(.L_x_7)"))
    assert changed["flash_bwd_dq_kernel<64>"] == here["flash_bwd_dq_kernel<64>"]
    assert changed["flash_fwd_kernel<64>"] != here["flash_fwd_kernel<64>"]
    assert compare_sass.first_difference(here["flash_fwd_kernel<64>"], changed["flash_fwd_kernel<64>"])["line"] == 2
