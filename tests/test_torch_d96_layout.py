"""The shared-memory layout of the bf16 forward kernel at head_dim 96
(`flash_fwd_kernel<96>`, mafed_tpu_torch/csrc/flash_attn.cu `fwd_cta` at D = 96),
emulated on the CPU.

That kernel keeps its [64][96] tiles without padding: three panels of
[64][32] bf16, each written by one TMA box of {32, 64, 1} with the 64-byte
swizzle, and reads them with wgmma through matrix descriptors of layout type
2: Q and K K-major for S = Q K^T (6 k-steps of m64n64k16), V MN-major for
O += P V (4 k-steps of m64n96k16, N over all three panels). The card's
instructions cannot run here, so this file models them as the PTX ISA
describes them and runs the source's own arithmetic through the model:

* a TMA box writes element (r, c) at dst + r W + 2 c, W the swizzle width in
  bytes (one box row), and the swizzle XORs the 16-byte chunk bits [4, 4 +
  b) of the address with bits [7, 7 + b), b = log2(W / 16);
* a descriptor holds start >> 4, LBO >> 4 and SBO >> 4 in bits 0, 16 and 32
  and the layout type in bits 62-63 (1: 128-byte swizzle, 2: 64-byte); its
  K-major operand reads element (row, k) at start + (row % 8) W + (row // 8)
  SBO + 2 k, its MN-major operand element (k, n) at start + (n % (W / 2)) 2
  + (n // (W / 2)) LBO + (k % 8) W + (k // 8) SBO, each then swizzled.

The descriptor functions (`desc_sw64`, `desc_k_major_sw64`,
`desc_mn_major_sw64` in csrc/sm90.cuh), the panel constants, the box and
swizzle of `make_map_3d_sw64` and the kernel's tile offsets (`FwdSmem`)
are read from the sources and evaluated here, so the tests pin them: every
element of a tile is read exactly once, in wgmma's order (k-step kk, its k
or row 16 kk + k), and no column past 95 is written or read. The same model
passes the 128-byte layout that every other bf16 kernel runs on the card,
and fails each field set wrong. The forward run through the model (the
kernel's control flow: two warpgroups' query tiles a CTA, each up to its
diagonal, the online softmax over 64-key tiles, P rounded to bf16) matches
the JAX package's Pallas forward in interpret mode. At 96 the dK/dV kernel
takes the same unpadded tiles (tests/test_torch_dkv_layout.py) and the dQ
kernel keeps the padded 128-column tile; the tests read both from the
launchers too.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mafed_tpu.kernels import attention as jattn
from mafed_tpu_torch.kernels import build

CSRC = Path(build.CSRC)
SM90 = (CSRC / "sm90.cuh").read_text()
FLASH = (CSRC / "flash_attn.cu").read_text()
D = 96
ATOL = RTOL = 2e-2  # bf16 outputs, as the card's kernel checks
LSE_ATOL = 1e-4
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM gives its CTAs (228 KB)
SWIZZLE_WIDTH = {1: 128, 2: 64}  # descriptor layout type -> swizzle width in bytes


# ---------------------------------------------------------------------------
# Reading the sources
# ---------------------------------------------------------------------------

def _body(src: str, signature: str) -> str:
    """The text between the braces of the function or struct that `signature` opens."""
    start = src.index("{", src.index(signature))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start + 1:i]
    raise ValueError(signature)


def _py(expr: str) -> str:
    """A C++ integer expression of these sources as Python."""
    expr = re.sub(r"//.*", "", expr)
    expr = expr.replace("sm90::", "").replace("(uint64_t)", "").replace("/", "//")
    return re.sub(r"(\d+)ull\b", r"\1", expr).strip()


def _constants(src: str, names) -> dict:
    """Evaluate `constexpr ... NAME = expr;` (or NAME = expr in a list of
    `constexpr int A = 1, NAME = expr, ...;`) of each name, in order."""
    env: dict = {}
    for name in names:
        expr = re.search(rf"constexpr\s+\w+\s+(?:\w+\s*=\s*[^,;]+,\s*)*{name}\s*=\s*([^,;]+)[,;]", src).group(1)
        env[name] = eval(_py(expr), {}, dict(env, **_SM90_CONSTANTS))
    return env


_SM90_CONSTANTS: dict = {}
_SM90_CONSTANTS.update(_constants(SM90, ("PANEL", "PANEL_BYTES", "PANEL_SW64", "PANEL_SW64_BYTES")))


def _descriptor_encoder(name: str):
    """The source's `desc_swNN(addr, lbo_bytes, sbo_bytes)` as a Python function."""
    lines = [_py(line) for line in _body(SM90, f"uint64_t {name}(").split(";")]
    code = "\n".join(re.sub(r"^uint64_t\s+", "", line) for line in lines if line and not line.startswith("return"))

    def encode(addr, lbo_bytes, sbo_bytes):
        env = {"addr": addr, "lbo_bytes": lbo_bytes, "sbo_bytes": sbo_bytes}
        exec(code, {}, env)
        return env["d"]
    return encode


def _descriptor_maker(name: str):
    """The source's `desc_*_major*(tile, ...)` as a Python function of its arguments."""
    params = re.search(rf"uint64_t {name}\(([^)]*)\)", SM90).group(1)
    args = [p.split()[-1] for p in params.split(",")]
    ret = re.search(r"return\s+(\w+)\((.*)\);", _body(SM90, f"uint64_t {name}("), re.S)
    encode = _descriptor_encoder(ret.group(1))
    expr = _py(ret.group(2))

    def build_desc(*values):
        return eval(f"encode({expr})", {"encode": encode}, dict(zip(args, values), **_SM90_CONSTANTS))
    return build_desc


FLASH_CONSTANTS = _constants(FLASH, ("BLOCK", "STAGES", "FWD_WG_96", "FWD_WG_128", "FWD_WG_256"))


def fwd_smem(d: int = D) -> dict:
    """FwdSmem<d, FWD_WG_d>'s byte offsets (and WG, STAGES), evaluated from the source."""
    env = {"BLOCK": FLASH_CONSTANTS["BLOCK"], "STAGES": FLASH_CONSTANTS["STAGES"], "D": d,
           "WG": FLASH_CONSTANTS[f"FWD_WG_{d}"]}
    for name, expr in re.findall(r"static constexpr \w+ (\w+) = ([^;]+);", _body(FLASH, "struct FwdSmem")):
        env[name] = eval(_py(expr), {}, dict(env, **_SM90_CONSTANTS))
    return env


def tile_bases(smem: dict) -> dict:
    """The tiles of one CTA at its 1024-aligned base: each warpgroup's Q, each stage's K and V."""
    return ({f"q{w}": smem["TILE"] * w for w in range(smem["WG"])}
            | {f"k{s}": smem["K"] + s * smem["TILE"] for s in range(smem["STAGES"])}
            | {f"v{s}": smem["V"] + s * smem["TILE"] for s in range(smem["STAGES"])})


# ---------------------------------------------------------------------------
# The model of TMA and wgmma
# ---------------------------------------------------------------------------

def _swizzle(addr, width: int):
    bits = (width // 16).bit_length() - 1
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def tma_write(smem: dict, dst: int, col0: int, box_cols: int, width: int, rows: int = 64, cols: int = D) -> None:
    """One TMA box of {box_cols, rows} at column col0 into `smem` ({byte address: (row, col)}); columns past
    `cols` arrive as zeros (None)."""
    assert box_cols * 2 == width, "a box row is one swizzle width"
    for r in range(rows):
        for c in range(box_cols):
            for byte in range(2):
                addr = _swizzle(dst + r * width + 2 * c + byte, width)
                assert addr not in smem, "two elements at one address"
                smem[addr] = (r, col0 + c) if col0 + c < cols else None


def decode(desc: int) -> dict:
    return {"start": (desc & 0x3FFF) << 4, "lbo": ((desc >> 16) & 0x3FFF) << 4,
            "sbo": ((desc >> 32) & 0x3FFF) << 4, "type": desc >> 62}


def k_major_read(smem: dict, desc: int, rows: int = 64):
    """(row, col) of the tile that a K-major operand of `rows` x k16 reads at each (row, k)."""
    f = decode(desc)
    width = SWIZZLE_WIDTH[f["type"]]
    out = np.empty((rows, 16), dtype=object)
    for r in range(rows):
        for k in range(16):
            out[r, k] = smem.get(_swizzle(f["start"] + (r % 8) * width + (r // 8) * f["sbo"] + 2 * k, width), "hole")
    return out


def mn_major_read(smem: dict, desc: int, n: int):
    """(row, col) of the tile that an MN-major B operand of k16 x n reads at each (k, n)."""
    f = decode(desc)
    width = SWIZZLE_WIDTH[f["type"]]
    atom = width // 2
    out = np.empty((16, n), dtype=object)
    for k in range(16):
        for j in range(n):
            addr = f["start"] + (j % atom) * 2 + (j // atom) * f["lbo"] + (k % 8) * width + (k // 8) * f["sbo"]
            out[k, j] = smem.get(_swizzle(addr, width), "hole")
    return out


def sw64_tile(base: int) -> dict:
    """A [64][96] tile at `base` as tma_load_tile_sw64<96> loads it with make_map_3d_sw64's boxes."""
    smem: dict = {}
    panels = D // _SM90_CONSTANTS["PANEL_SW64"]
    for p in range(panels):
        tma_write(smem, base + p * _SM90_CONSTANTS["PANEL_SW64_BYTES"], p * _SM90_CONSTANTS["PANEL_SW64"],
                  MAP_BOX[0], MAP_SWIZZLE)
    return smem


def _map_box_and_swizzle(name: str):
    body = _body(FLASH if name not in SM90 else SM90, f"cudaError_t {name}(")
    box = tuple(int(x) for x in re.search(r"box\[3\] = \{([^}]*)\}", body).group(1).split(","))
    swizzle = int(re.search(r"CU_TENSOR_MAP_SWIZZLE_(\d+)B", body).group(1))
    return box, swizzle


MAP_BOX, MAP_SWIZZLE = _map_box_and_swizzle("make_map_3d_sw64")
K_MAJOR_SW64 = _descriptor_maker("desc_k_major_sw64")
MN_MAJOR_SW64 = _descriptor_maker("desc_mn_major_sw64")
SMEM = fwd_smem()
TILE_BASES = tile_bases(SMEM)
BASE = 0x8000  # a 1024-aligned shared address for the CTA's base


def s_reads(smem: dict, base: int, k_major=K_MAJOR_SW64, d: int = D) -> list:
    """The (row, col) each k-step of S = Q K^T reads from one K-major operand tile."""
    return [k_major_read(smem, k_major(base, kk)) for kk in range(d // 16)]


def pv_reads(smem: dict, base: int, mn_major=MN_MAJOR_SW64, n: int = D) -> list:
    """The (row, col) each k-step of O += P V reads from the V tile."""
    return [mn_major_read(smem, mn_major(base, kk), n) for kk in range(4)]


def read_exactly_once_in_order(reads, want, d: int = D) -> None:
    seen = []
    for kk, got in enumerate(reads):
        for idx in np.ndindex(got.shape):
            assert got[idx] == want(kk, *idx), f"k-step {kk} at {idx}: read {got[idx]}, wants {want(kk, *idx)}"
            seen.append(got[idx])
    assert sorted(seen) == [(r, c) for r in range(64) for c in range(d)]


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

def test_sw64_descriptors_encode_the_fields_of_the_ptx_layout():
    """desc_sw64 puts start, LBO and SBO (16-byte units) in bits 0, 16 and 32
    and layout type 2 (the 64-byte swizzle) in bits 62-63; desc_sw128, left as
    it was, type 1."""
    got = decode(_descriptor_encoder("desc_sw64")(0x1A340, 4096, 512))
    assert got == {"start": 0x1A340, "lbo": 4096, "sbo": 512, "type": 2}
    assert decode(_descriptor_encoder("desc_sw128")(0x1A340, 8192, 1024))["type"] == 1
    assert SWIZZLE_WIDTH[2] == MAP_SWIZZLE == 2 * MAP_BOX[0] and MAP_BOX == (32, 64, 1)


def test_tiles_are_unpadded_and_swizzle_aligned():
    """FwdSmem's tiles at 96 are 12 KB ([64][96] bf16, nothing padded), each at a
    multiple of 512 bytes from the 1024-aligned base (the 64-byte swizzle's
    period), and two CTAs fit an SM's shared memory."""
    assert SMEM["TILE"] == 64 * D * 2 == 12288
    assert all(base % 512 == 0 for base in TILE_BASES.values())
    assert len(set(TILE_BASES.values())) == len(TILE_BASES)
    assert SMEM["KEEP"] == max(TILE_BASES.values()) + SMEM["TILE"]
    assert 2 * (SMEM["ALLOC"] + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("tile", sorted(TILE_BASES))
def test_tma_writes_every_element_of_a_tile_once(tile):
    """tma_load_tile_sw64<96>: three boxes of 32 columns fill the tile's 12 KB
    byte for byte, every element once, no column past 95, nothing outside it."""
    base = BASE + TILE_BASES[tile]
    smem = sw64_tile(base)
    assert sorted(smem) == list(range(base, base + SMEM["TILE"]))
    assert None not in smem.values() and max(c for _, c in smem.values()) == D - 1
    assert re.search(r"tma_load_3d\(dst \+ p \* PANEL_SW64_BYTES, map, bar, p \* PANEL_SW64, row, plane\)",
                     _body(SM90, "void tma_load_tile_sw64("))


@pytest.mark.parametrize("tile", [t for t in sorted(TILE_BASES) if t[0] in "qk"])
def test_score_product_reads_q_and_k_once_in_k_order(tile):
    """S = Q K^T: k-step kk (0..5) of desc_k_major_sw64 reads (row, 16 kk + k)
    of the tile, so every element once, in wgmma's order."""
    base = BASE + TILE_BASES[tile]
    read_exactly_once_in_order(s_reads(sw64_tile(base), base), lambda kk, r, k: (r, 16 * kk + k))


@pytest.mark.parametrize("tile", [t for t in sorted(TILE_BASES) if t[0] == "v"])
def test_pv_product_reads_v_once_over_all_96_columns(tile):
    """O += P V: k-step kk (0..3) of desc_mn_major_sw64 reads (16 kk + k, n)
    for n < 96 across the three panels (LBO), so every element once."""
    base = BASE + TILE_BASES[tile]
    read_exactly_once_in_order(pv_reads(sw64_tile(base), base), lambda kk, k, n: (16 * kk + k, n))


def test_the_model_passes_the_128_byte_layout_the_other_kernels_run():
    """The same model, on the layout every other bf16 kernel runs on the card
    (make_map_3d's {64, 64} boxes with the 128-byte swizzle, desc_k_major and
    desc_mn_major, a [64][128] tile): k-step kk reads (row, 16 kk + k) K-major
    and (16 kk + k, 64 n + j) MN-major from panel n."""
    box, swizzle = _map_box_and_swizzle("make_map_3d")
    assert box == (64, 64, 1) and swizzle == 128
    k_major, mn_major = _descriptor_maker("desc_k_major"), _descriptor_maker("desc_mn_major")
    smem: dict = {}
    for p in range(2):
        tma_write(smem, BASE + p * _SM90_CONSTANTS["PANEL_BYTES"], 64 * p, 64, 128, cols=128)
    for kk in range(8):
        got = k_major_read(smem, k_major(BASE, kk))
        assert all(got[r, k] == (r, 16 * kk + k) for r, k in np.ndindex(got.shape))
    for n in range(2):
        for kk in range(4):
            got = mn_major_read(smem, mn_major(BASE, n, kk), 64)
            assert all(got[k, j] == (16 * kk + k, 64 * n + j) for k, j in np.ndindex(got.shape))


MUTATIONS = {
    "sbo_1024": lambda d: d + ((512 >> 4) << 32),
    "lbo_8192": lambda d: d + ((4096 >> 4) << 16),
    "layout_128_byte": lambda d: (d & ~(3 << 62)) | (1 << 62),
    "odd_step_16_bytes": lambda d: d - 1,  # start 16 bytes lower
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_the_model_catches_a_field_set_wrong(mutation):
    """Each descriptor field set wrong (SBO, LBO, layout type, start) makes
    some k-step read a wrong element or a hole, in S or in P V."""
    smem = sw64_tile(BASE)
    wrong = MUTATIONS[mutation]
    reads = ([k_major_read(smem, wrong(K_MAJOR_SW64(BASE, kk))) for kk in range(D // 16)]
             + [mn_major_read(smem, wrong(MN_MAJOR_SW64(BASE, kk)), D) for kk in range(4)])
    right = s_reads(smem, BASE) + pv_reads(smem, BASE)
    assert any((got != want).any() for got, want in zip(reads, right))


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def _case_96(entry: str) -> str:
    body = _body(FLASH, f'extern "C" cudaError_t {entry}(')
    return re.search(r"case 96:\s*return (\w+(?:<[^>]*>)?)\(", body).group(1)


def test_forward_launcher_at_96_takes_the_unpadded_tile():
    """flash_attn_fwd at 96 goes to launch_fwd<96, FWD_WG_96>: three
    32-column maps, FwdSmem, FWD_WG_96 query tiles a CTA, the kernel
    flash_fwd_kernel<96> (kernels/build.py reads it under that name), whose
    fwd_cta loads, reads and multiplies the tiles at 96 as the model does."""
    assert _case_96("flash_attn_fwd") == "launch_fwd<96, FWD_WG_96>"
    body = _body(FLASH, "cudaError_t launch_fwd(")
    assert "const auto make_map = D == 96 ? sm90_host::make_map_3d_sw64 : sm90_host::make_map_3d;" in body
    assert body.count("make_map(") == 3
    assert "FwdSmem<D, WG>::ALLOC" in body and "flash_fwd_kernel<D, WG><<<" in body
    assert "(n_qt + WG - 1) / WG" in body
    assert build.route("flash_fwd", "bfloat16", 96).instantiation == "flash_fwd_kernel<96>"
    assert re.search(r"if constexpr \(D == 96\)\s*sm90::tma_load_tile_sw64<D>\(", _body(FLASH, "void load_tile("))
    assert re.search(r"if constexpr \(D == 96\)\s*return sm90::desc_k_major_sw64\(tile, kk\);",
                     _body(FLASH, "uint64_t desc_k("))
    assert re.search(r"if constexpr \(D == 96\)\s*sm90::wgmma_rs_n96\(acc, a, sm90::desc_mn_major_sw64\(sV, kk\)\);",
                     _body(FLASH, "void fwd_pv("))
    cta = _body(FLASH, "void fwd_cta(")
    assert "sm90::wgmma_ss(sc, desc_k<D>(sQ, kk), desc_k<D>(sK, kk), kk > 0)" in cta
    assert "for (int kk = 0; kk < 4; ++kk) fwd_pv<D>(acc, pa[kk], sV, kk);" in cta
    assert "m64n96k16" in _body(SM90, "void wgmma_rs_n96(")


@pytest.mark.parametrize("entry,launcher", [("flash_attn_bwd_dq", "launch_bwd_dq")])
def test_backward_launchers_at_96_keep_the_128_column_tile(entry, launcher):
    """The dQ launcher at 96 still runs the D = 128 tile: the generic
    template at D = 96, make_map_3d's 64-column boxes, tiles of panels(96) =
    2 panels of 64 columns (128, the last 32 zeros)."""
    assert _case_96(entry).startswith(f"{launcher}<96, ")
    body = _body(FLASH, f"cudaError_t {launcher}(")
    assert body.count("make_map_3d(") == 4 and "sw64" not in body
    panels = re.search(r"constexpr int panels\(int d\) \{ return ([^;]+); \}", FLASH).group(1)
    assert eval(_py(panels), {}, {"d": 96}) * 64 == 128
    assert re.search(r"struct QTileSmem[^{]*\{\s*(//[^\n]*)?\s*static constexpr uint32_t TILE = panels\(D\) \* "
                     r"sm90::PANEL_BYTES;", FLASH)
    kernel = _body(FLASH, f"{launcher.replace('launch', 'flash')}_kernel(")
    assert "sw64" not in kernel and "sm90::desc_k_major(" in kernel


def test_dkv_launcher_at_96_takes_the_unpadded_tile():
    """flash_attn_bwd_dkv at 96 goes to launch_bwd_dkv<96, DKV_WG_96>: four
    32-column maps (q, k, v, dO: make_map_3d_sw64 at 96), DkvSmem's 12 KB
    tiles, the kernel flash_bwd_dkv_kernel<96> (kernels/build.py reads it
    under that name), whose dkv_cta loads and reads the tiles at 96 as the
    model does (tests/test_torch_dkv_layout.py)."""
    assert _case_96("flash_attn_bwd_dkv") == "launch_bwd_dkv<96, DKV_WG_96>"
    body = _body(FLASH, "cudaError_t launch_bwd_dkv(")
    assert "const auto make_map = D == 96 ? sm90_host::make_map_3d_sw64 : sm90_host::make_map_3d;" in body
    assert body.count("make_map(") == 4 and "using L = DkvSmem<D, WG>;" in body
    assert re.search(r"static constexpr uint32_t TILE = D == 96 \? BLOCK \* D \* 2 :", _body(FLASH, "struct DkvSmem"))
    assert build.route("flash_bwd_dkv", "bfloat16", 96).instantiation == "flash_bwd_dkv_kernel<96>"
    cta = _body(FLASH, "void dkv_cta(")
    assert "load_tile<D>(smem + L::K, tm_k, &bar[0], k0, bh);" in cta and "sm90::tma_load_tile<" not in cta
    assert "sm90::desc_mn_major_sw64(sDO, kk)" in cta and "sm90::desc_mn_major_sw64(sQ, kk)" in cta


# ---------------------------------------------------------------------------
# The forward through the model
# ---------------------------------------------------------------------------

def _operand_maps():
    """Index arrays (rows, cols) of what each k-step reads, from the model: S's Q and K operands, P V's V."""
    def split(reads):
        return [(np.vectorize(lambda x: x[0])(r), np.vectorize(lambda x: x[1])(r)) for r in reads]
    q_smem, k_smem, v_smem = (sw64_tile(BASE + TILE_BASES[t]) for t in ("q0", "k0", "v0"))
    return (split(s_reads(q_smem, BASE + TILE_BASES["q0"])), split(s_reads(k_smem, BASE + TILE_BASES["k0"])),
            split(pv_reads(v_smem, BASE + TILE_BASES["v0"])))


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def cta_plan(wg: int):
    """fwd_cta's split of a CTA of `wg` query tiles: for warpgroup w of CTA
    x, its query tile, the key tiles the CTA streams (its last warpgroup's)
    and those the warpgroup computes (causal: up to its own diagonal)."""
    def plan(cta, w, n_qt, n_kt, causal):
        first = cta * wg
        n_tiles = min(wg, n_qt - first)
        upper = min(first + n_tiles, n_kt) if causal else n_kt
        qt = first + w
        mine = 0 if qt >= n_qt else min(qt + 1, n_kt) if causal else n_kt
        return qt, upper, mine
    return plan


def emulated_forward(q, k, v, mask, causal: bool, scale: float, maps=None, wg=None, plan=None):
    """(o, lse) of fwd_cta with every operand read through the model (`maps`,
    as _operand_maps gives them; at 96 by default): the kernel's CTAs of
    `wg` query tiles (FWD_WG_96 by default), split as `plan` says (cta_plan
    by default), each warpgroup up to its own diagonal, the log2-domain
    online softmax over 64-key tiles (masked tiles filled with
    finfo(f32).min, keep zeroing), P rounded to bf16."""
    q_maps, k_maps, v_maps = _operand_maps() if maps is None else maps
    wg = FLASH_CONSTANTS["FWD_WG_96"] if wg is None else wg
    plan = cta_plan(wg) if plan is None else plan
    b_, h_, q_len, d = q.shape
    kv_len = k.shape[2]
    n_qt, n_kt = -(-q_len // 64), -(-kv_len // 64)
    neg, log2e = np.float32(np.finfo(np.float32).min), np.float32(1.4426950408889634)
    o = np.zeros(q.shape, np.float32)
    lse = np.zeros(q.shape[:3], np.float32)

    def tile(x, t):  # rows 64 t .. 64 t + 63, zeros past the end (TMA's fill)
        out = np.zeros((64, d), np.float32)
        part = x[64 * t:64 * t + 64]
        out[:len(part)] = part
        return out

    for b in range(b_):
        keep_keys = np.zeros(n_kt * 64, bool)
        keep_keys[:kv_len] = mask[b] > 0
        for h in range(h_):
            for cta in range(-(-n_qt // wg)):
                for w in range(wg):
                    qt, upper, mine = plan(cta, w, n_qt, n_kt, causal)
                    if qt >= n_qt:
                        continue
                    qtile = tile(q[b, h], qt)
                    acc = np.zeros((64, d), np.float32)
                    m = np.full(64, -np.inf, np.float32)
                    l = np.zeros(64, np.float32)
                    for kt in range(min(mine, upper)):
                        ktile, vtile = tile(k[b, h], kt), tile(v[b, h], kt)
                        s = sum(qtile[qr, qc] @ ktile[kr, kc].T for (qr, qc), (kr, kc) in zip(q_maps, k_maps))
                        x = s.astype(np.float32) * np.float32(scale * log2e)
                        keep = np.broadcast_to(keep_keys[64 * kt:64 * kt + 64], (64, 64)).copy()
                        diag = causal and kt == qt
                        if diag:
                            keep &= np.tril(np.ones((64, 64), bool))
                        if diag or not keep.all():
                            x = np.where(keep, x, neg)
                        m_new = np.maximum(m, x.max(axis=1))
                        alpha = np.exp2(m - m_new)
                        m_sub = np.where(m_new == neg, np.inf, m_new)
                        p = np.exp2(x - m_sub[:, None]).astype(np.float32)
                        l = l * alpha + p.sum(axis=1)
                        m = m_new
                        pb = _bf16(p)
                        acc = acc * alpha[:, None] + sum(pb[:, 16 * kk:16 * kk + 16] @ vtile[vr, vc]
                                                         for kk, (vr, vc) in enumerate(v_maps))
                    empty = l == 0
                    l_safe = np.where(empty, 1.0, l).astype(np.float32)
                    rows = slice(64 * qt, min(64 * qt + 64, q_len))
                    n = rows.stop - rows.start
                    o[b, h, rows] = (acc / l_safe[:, None])[:n]
                    lse[b, h, rows] = np.where(empty, np.inf, m * np.float32(np.log(2)) + np.log(l_safe))[:n]
    return o, lse


# (batch, heads, q_len, kv_len, causal, masked key range, all-masked last sample)
FWD_CASES = {
    "causal_77_empty_rows": (2, 2, 77, 77, True, (0, 3), True),
    "causal_129_padded": (1, 2, 129, 129, True, (0, 7), False),
    "causal_320_five_tiles": (1, 1, 320, 320, True, (256, 276), False),
    "noncausal_65_by_200_masked": (2, 1, 65, 200, False, (150, 200), False),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_emulated_forward_matches_pallas(case):
    """The forward through the model against the JAX package's Pallas forward
    (interpret mode) at bf16, head_dim 96: o within the card's bf16
    tolerance, lse within 1e-4, empty rows with lse +inf and o 0 in both."""
    b, h, tq, tk, causal, masked, empty = FWD_CASES[case]
    rng = np.random.default_rng(20)
    q, k, v = (_bf16(rng.normal(size=(b, h, n, D))) for n in (tq, tk, tk))
    mask = np.ones((b, tk), np.int32)
    mask[:, masked[0]:masked[1]] = 0
    if empty:
        mask[-1] = 0
    scale = D ** -0.5
    o, lse = emulated_forward(q, k, v, mask, causal, scale)
    prev = jattn._INTERPRET
    jattn._INTERPRET = True
    try:
        ref_o, ref_lse = (np.asarray(x, dtype=np.float32) for x in jattn._flash_forward(
            *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask), causal=causal,
            scale=scale, block_q=64, block_k=64, use_mask=True))
    finally:
        jattn._INTERPRET = prev
    np.testing.assert_allclose(_bf16(o), ref_o, atol=ATOL, rtol=RTOL, err_msg="o")
    fin = np.isfinite(ref_lse)
    np.testing.assert_allclose(lse[fin], ref_lse[fin], atol=LSE_ATOL, rtol=0, err_msg="lse")
    assert np.array_equal(np.isinf(lse), ~fin) and (o[~fin] == 0).all()
