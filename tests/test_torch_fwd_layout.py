"""The bf16 forward kernel at head_dim 128 and 256 (`flash_fwd_kernel<128>`,
`<256>`: mafed_tpu_torch/csrc/flash_attn.cu `fwd_cta`), emulated on the CPU
with the model of TMA and wgmma in tests/test_torch_d96_layout.py.

At these head_dims the kernel splits query rows over its warpgroups: a CTA
holds FWD_WG_128 (FWD_WG_256) warpgroups, each with its own 64-row query tile
and all of its O, each forming each 64 x 64 score tile once over all of D;
they share each K/V tile of the CTA's ring. Its tiles are [64][D] as D / 64
panels of 64 columns, written by TMA in {64, 64} boxes with the 128-byte
swizzle; S = Q K^T reads Q and K K-major (D / 16 k-steps of m64n64k16), and
O += P V reads V MN-major in one m64n128k16 (m64n256k16) a k-step, N over all
of V's panels through the descriptor's LBO.

Read from the sources and checked here: the warpgroup and stage counts, the
shared-memory offsets (`FwdSmem`) and the launcher's grid; every tile
1024-aligned and the whole within the 227 KB a CTA may have; every query row
owned by exactly one warpgroup and each CTA streaming exactly the key tiles
its last warpgroup needs (the kernel's own index arithmetic, evaluated); the
descriptors of the wide P V product pinned by the model, a wrong LBO caught.
The forward run through the model with that control flow matches the JAX
package's Pallas forward in interpret mode at odd counts of query tiles.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp

from mafed_tpu.kernels import attention as jattn

from test_torch_d96_layout import (BASE, FLASH, LSE_ATOL, SM90, SMEM_PER_SM, _SM90_CONSTANTS, _bf16, _body,
                                   _descriptor_maker, _map_box_and_swizzle, _py, cta_plan, emulated_forward,
                                   fwd_smem, k_major_read, mn_major_read, read_exactly_once_in_order, s_reads,
                                   tile_bases, tma_write)

ATOL = RTOL = 2e-2  # bf16 outputs, as the card's kernel checks
HEAD_DIMS = (128, 256)
SMEM_PER_CTA = 232448  # the most shared memory one CTA may have on an H100 (227 KB)
K_MAJOR = _descriptor_maker("desc_k_major")
MN_MAJOR = _descriptor_maker("desc_mn_major")
PANEL, PANEL_BYTES = _SM90_CONSTANTS["PANEL"], _SM90_CONSTANTS["PANEL_BYTES"]


def sw128_tile(base: int, d: int) -> dict:
    """A [64][d] tile at `base` as tma_load_tile<d> loads it with make_map_3d's boxes."""
    box, swizzle = _map_box_and_swizzle("make_map_3d")
    smem: dict = {}
    for p in range(d // PANEL):
        tma_write(smem, base + p * PANEL_BYTES, p * PANEL, box[0], swizzle, cols=d)
    return smem


def pv_reads(smem: dict, base: int, d: int, lbo=None) -> list:
    """The (row, col) that each k-step of fwd_pv<d> reads from the V tile:
    desc_mn_major(sV, 0, kk) over N = d columns (LBO optionally replaced)."""
    descs = [MN_MAJOR(base, 0, kk) for kk in range(4)]
    if lbo is not None:
        descs = [(x & ~(0x3FFF << 16)) | ((lbo >> 4) << 16) for x in descs]
    return [mn_major_read(smem, x, d) for x in descs]


# ---------------------------------------------------------------------------
# The kernel's control flow, read from fwd_cta and launch_fwd
# ---------------------------------------------------------------------------

def _ternary(expr: str) -> str:
    """A C expression with `a ? b : c` (right-associative) as Python."""
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:
        return expr.strip()
    depth, nested = 0, 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth == 0 and ch == "?":
            nested += 1
        elif depth == 0 and ch == ":":
            if nested == 0:
                return f"({_ternary(expr[q + 1:i])}) if ({_ternary(expr[:q])}) else ({_ternary(expr[i + 1:])})"
            nested -= 1
    raise ValueError(expr)


def _declarations(body: str, first: str) -> list:
    """(name, Python expression) of each declarator of the `const int` line whose first name is `first`."""
    line = re.search(rf"const int {first} = ([^;]+);", body).group(0)[len("const int "):-1]
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(line):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            parts.append(line[start:i])
            start = i + 1
    parts.append(line[start:])
    out = []
    for part in parts:
        name, expr = part.split("=", 1)
        out.append((name.strip(), _ternary(_py(expr.replace("blockIdx.x", "bx").replace("&&", " and ")))))
    return out


FWD_CTA = _body(FLASH, "void fwd_cta(")
PLAN_LINES = [_declarations(FWD_CTA, first) for first in ("qt_first", "upper", "mine")]


def source_plan(wg: int):
    """fwd_cta's own split, evaluated: for warpgroup w of CTA x, (qt, upper, mine)."""
    def plan(cta, w, n_qt, n_kt, causal):
        env = {"bx": cta, "WG": wg, "wg": w, "n_qt": n_qt, "n_kt": n_kt, "causal": int(causal), "min": min}
        for line in PLAN_LINES:
            for name, expr in line:
                env[name] = eval(expr, {}, env)
        return env["qt"], env["upper"], env["mine"]
    return plan


def launch_grid_x(d: int, q_len: int) -> int:
    """launch_fwd's grid.x at head_dim d, evaluated from the source."""
    body = _body(FLASH, "cudaError_t launch_fwd(")
    n_qt = eval(_py(re.search(r"const int n_qt = ([^;]+);", body).group(1)), {}, {"q_len": q_len, "BLOCK": 64})
    grid_x = re.search(r"const dim3 grid\((.+), batch_heads\);", body).group(1)
    return eval(_py(grid_x), {}, {"n_qt": n_qt, "WG": fwd_smem(d)["WG"]})


# ---------------------------------------------------------------------------
# Constants, shared memory, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_launcher_takes_the_query_split_kernel(d):
    """flash_attn_fwd at d goes to launch_fwd<d, FWD_WG_d> (128-byte maps),
    and the kernel's template sends every head_dim but 64 to fwd_cta, whose
    P V at d is one m64n{d}k16 a k-step on desc_mn_major(sV, 0, kk)."""
    body = _body(FLASH, 'extern "C" cudaError_t flash_attn_fwd(')
    assert re.search(rf"case {d}:\s*return launch_fwd<{d}, FWD_WG_{d}>\(", body)
    assert re.search(r"if constexpr \(D != 64\) \{[^}]*fwd_cta<D, WG>\(", _body(FLASH, "flash_fwd_kernel("))
    pv = _body(FLASH, "void fwd_pv(")
    assert f"sm90::wgmma_rs_n{d}(acc, a, sm90::desc_mn_major(sV, 0, kk));" in pv
    wrapper = _body(SM90, f"void wgmma_rs_n{d}(")
    assert f"m64n{d}k16.f32.bf16.bf16" in wrapper and f"SM90_D{d // 2}_LIST" in wrapper
    # the accumulator list names d / 2 registers, then A's four, the descriptor and the scale-d predicate
    lst = re.search(rf"#define SM90_D{d // 2}_LIST (.*?)(?=\n#define|\n\n)", SM90, re.S).group(1)
    assert re.findall(r"%(\d+)", lst) == [str(i) for i in range(d // 2)]
    regs = [int(x) for x in re.findall(r"%(\d+)", wrapper.split("SM90_D")[1])]
    assert regs == [d // 2 + i for i in range(5)]
    assert re.search(rf"setp\.ne\.b32 p, %{d // 2 + 5}, 0", wrapper)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_are_aligned_and_fit_a_cta(d):
    """FwdSmem at d: [64][d] tiles of d / 64 swizzle panels, each at a
    multiple of 1024 bytes from the 1024-aligned base, no two overlapping,
    the keep bits and barriers after them, the whole within 227 KB; the Q
    barrier counts n_tiles whole tiles, and a tile is d / 64 boxes of 8 KB;
    at 128 two CTAs fit an SM."""
    smem = fwd_smem(d)
    bases = tile_bases(smem)
    assert smem["TILE"] == 64 * d * 2 == d // PANEL * PANEL_BYTES
    assert all(base % 1024 == 0 for base in bases.values()) and len(set(bases.values())) == len(bases)
    assert smem["KEEP"] == max(bases.values()) + smem["TILE"] and smem["BAR"] == smem["KEEP"] + 8 * smem["STAGES"]
    assert smem["ALLOC"] <= SMEM_PER_CTA
    if d == 128:  # two CTAs an SM: by shared memory, and by registers through the launch bound
        assert 2 * (smem["ALLOC"] + 1024) <= SMEM_PER_SM
        assert re.search(r"template <>\s*__global__ void __launch_bounds__\(THREADS \* FWD_WG_128, 2\)\s*"
                         r"flash_fwd_kernel<128, FWD_WG_128>\(", FLASH)
    assert "sm90::mbar_expect_tx(&bar[0], n_tiles * L::TILE);" in FWD_CTA
    assert "for (int w = 0; w < n_tiles; ++w)" in FWD_CTA
    assert "sm90::mbar_expect_tx(&bar[1 + s], 2 * L::TILE);" in FWD_CTA


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_every_query_row_has_one_warpgroup_and_each_cta_its_key_tiles(d, causal):
    """Over launch_fwd's grid, each query tile (so each row) belongs to
    exactly one warpgroup; a warpgroup past the last tile computes nothing;
    each CTA streams exactly the key tiles its last warpgroup needs, and each
    warpgroup computes exactly its own (causal: up to its diagonal)."""
    wg = fwd_smem(d)["WG"]
    plan = source_plan(wg)
    for q_len in (1, 20, 63, 64, 65, 130, 192, 320, 336, 577):
        n_qt = n_kt = -(-q_len // 64)
        owners = []
        for cta in range(launch_grid_x(d, q_len)):
            mines = []
            for w in range(wg):
                qt, upper, mine = plan(cta, w, n_qt, n_kt, causal)
                assert (qt, upper, mine) == cta_plan(wg)(cta, w, n_qt, n_kt, causal)
                if qt < n_qt:
                    owners.append(qt)
                    assert mine == (qt + 1 if causal else n_kt)
                else:
                    assert mine == 0
                mines.append(mine)
            assert upper == max(mines) and upper <= n_kt
        assert sorted(owners) == list(range(n_qt)), (q_len, owners)


# ---------------------------------------------------------------------------
# The layout through the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tma_and_the_score_product_read_each_element_once(d):
    """tma_load_tile<d> with make_map_3d's boxes writes each element of a
    tile once; S = Q K^T's d / 16 k-steps of desc_k_major read (row, 16 kk +
    k), so every element once, in wgmma's order."""
    smem = fwd_smem(d)
    for name, offset in tile_bases(smem).items():
        base = BASE + offset
        tile = sw128_tile(base, d)
        assert sorted(tile) == list(range(base, base + smem["TILE"])) and None not in tile.values()
        if name[0] in "qk":
            read_exactly_once_in_order(s_reads(tile, base, K_MAJOR, d), lambda kk, r, k: (r, 16 * kk + k), d)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_wide_pv_product_reads_v_once_across_its_panels(d):
    """O += P V in one m64n{d}k16 a k-step: desc_mn_major(sV, 0, kk) reads
    (16 kk + k, n) for every n < d, panel n // 64 through LBO (one panel of
    8 KB), so every element of V once; an LBO set wrong reads other
    elements."""
    smem = fwd_smem(d)
    for s in range(smem["STAGES"]):
        base = BASE + smem["V"] + s * smem["TILE"]
        tile = sw128_tile(base, d)
        read_exactly_once_in_order(pv_reads(tile, base, d), lambda kk, k, n: (16 * kk + k, n), d)
        assert all(MN_MAJOR(base, 0, kk) >> 16 & 0x3FFF == PANEL_BYTES >> 4 for kk in range(4))
        for wrong in (1024, 2 * PANEL_BYTES):
            right = pv_reads(tile, base, d)
            assert any((got != want).any() for got, want in zip(pv_reads(tile, base, d, lbo=wrong), right))


# ---------------------------------------------------------------------------
# The forward through the model
# ---------------------------------------------------------------------------

def _operand_maps(d: int):
    """Index arrays (rows, cols) of what each k-step reads, from the model: S's Q and K operands, P V's V."""
    def split(reads):
        return [(np.vectorize(lambda x: x[0])(r), np.vectorize(lambda x: x[1])(r)) for r in reads]
    bases = {name: BASE + offset for name, offset in tile_bases(fwd_smem(d)).items()}
    q_smem, k_smem, v_smem = (sw128_tile(bases[t], d) for t in ("q0", "k0", "v0"))
    return (split(s_reads(q_smem, bases["q0"], K_MAJOR, d)), split(s_reads(k_smem, bases["k0"], K_MAJOR, d)),
            split(pv_reads(v_smem, bases["v0"], d)))


# (batch, heads, q_len, causal, masked key range, all-masked last sample): odd counts of query tiles (1, 3, 5)
FWD_CASES = {
    "causal_20_one_tile": (2, 1, 20, True, (0, 3), True),
    "causal_64_one_tile": (1, 2, 64, True, (5, 9), False),
    "causal_130_three_tiles": (1, 1, 130, True, (0, 7), False),
    "causal_320_five_tiles": (1, 1, 320, True, (256, 272), False),
    "noncausal_130_three_tiles": (1, 1, 130, False, (100, 140), False),
}


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_emulated_forward_matches_pallas(d, case):
    """The forward through the model, with fwd_cta's own split of query
    tiles over warpgroups, against the JAX package's Pallas forward
    (interpret mode) at bf16: o within the card's bf16 tolerance (atol =
    rtol = 2e-2), lse within 1e-4, empty rows with lse +inf and o 0 in
    both."""
    b, h, t, causal, masked, empty = FWD_CASES[case]
    rng = np.random.default_rng(21)
    q, k, v = (_bf16(rng.normal(size=(b, h, t, d))) for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[:, masked[0]:masked[1]] = 0
    if empty:
        mask[-1] = 0
    scale = d ** -0.5
    wg = fwd_smem(d)["WG"]
    o, lse = emulated_forward(q, k, v, mask, causal, scale, maps=_operand_maps(d), wg=wg, plan=source_plan(wg))
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
