"""The bf16 dK/dV kernel at head_dim 256 and 96 (`flash_bwd_dkv_kernel<256>`,
`<96>`: mafed_tpu_torch/csrc/flash_attn.cu `dkv_cta`), emulated on the CPU
with the model of TMA and wgmma in tests/test_torch_d96_layout.py.

At 256 the CTA's two warpgroups share one 64-key tile. Warpgroup w forms S^T
= K Q^T and dP^T = V dO^T for queries 32 w .. 32 w + 31 of each Q/dO tile
only (m64n32k16, the B descriptor starting 32 w rows into each 128-byte
swizzled panel), writes its columns of P^T and dS^T as bf16 into two [64
keys][64 queries] panels of shared memory (`sw128_offset`), and after a
barrier reads both whole panels K-major as the A operand of dV += P^T dO and
dK += dS^T Q into its 128 columns (m64n128k16, dO and Q MN-major across two
panels). At 96 the tiles are unpadded ([64][96], three 32-column panels, the
64-byte swizzle), S^T and dP^T in 6 k-steps and dV, dK one m64n96k16 a
k-step from registers, one warpgroup a CTA.

Read from the sources and checked here: `DkvSmem` (every tile aligned, the
whole within 227 KB, three CTAs an SM at 96, the offsets at 64 and 128 those
the template's own body has always had), the kernel's split of key tiles and
query columns (each (key, query) element of S^T and dP^T formed by exactly
one warpgroup; each key tile owned by one CTA of the launch grid), the exchange
panels' addresses as the accumulator fragments write them and as the A
descriptor reads them (every element once, in wgmma's order), and the m64n128
/ m64n96 MN-major reads of dO and Q. dK and dV run through the model with
that control flow match the JAX package's Pallas kernel in interpret mode.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp

from mafed_tpu.kernels import attention as jattn

from test_torch_d96_layout import (BASE, FLASH, SM90, SMEM_PER_SM, _SM90_CONSTANTS, _bf16, _body, _constants,
                                   _descriptor_maker, _py, k_major_read, mn_major_read, read_exactly_once_in_order,
                                   sw64_tile)
from test_torch_fwd_layout import SMEM_PER_CTA, _declarations, _ternary, sw128_tile

ATOL = RTOL = 2e-2  # bf16 outputs, as the card's kernel checks
HEAD_DIMS = (96, 256)
PANEL, PANEL_BYTES = _SM90_CONSTANTS["PANEL"], _SM90_CONSTANTS["PANEL_BYTES"]
K_MAJOR, MN_MAJOR = _descriptor_maker("desc_k_major"), _descriptor_maker("desc_mn_major")
K_MAJOR_SW64, MN_MAJOR_SW64 = _descriptor_maker("desc_k_major_sw64"), _descriptor_maker("desc_mn_major_sw64")
CONSTANTS = _constants(FLASH, ("BLOCK", "STAGES", "DKV_WG_96", "DKV_WG_128", "DKV_WG_256"))
DKV_CTA = _body(FLASH, "void dkv_cta(")
LOG2E = np.float32(1.4426950408889634)


def _c_expr(expr: str) -> str:
    """A C integer expression with `a ? b : c` at any depth of parentheses as Python."""
    out, i = "", 0
    while i < len(expr):
        if expr[i] != "(":
            out, i = out + expr[i], i + 1
            continue
        depth = 0
        for j in range(i, len(expr)):
            depth += {"(": 1, ")": -1}.get(expr[j], 0)
            if depth == 0:
                break
        out, i = out + "(" + _c_expr(expr[i + 1:j]) + ")", j + 1
    return _ternary(out)


def dkv_smem(d: int, wg: int = None) -> dict:
    """DkvSmem<d, wg>'s byte offsets (wg DKV_WG_d by default), evaluated from the source."""
    wg = CONSTANTS.get(f"DKV_WG_{d}", 1) if wg is None else wg  # 64 takes one
    env = dict(CONSTANTS, D=d, WG=wg, panels=lambda x: (x + 63) // 64)
    for name, expr in re.findall(r"static constexpr \w+ (\w+) = ([^;]+);", _body(FLASH, "struct DkvSmem")):
        env[name] = eval(_c_expr(_py(expr)), {}, dict(env, **_SM90_CONSTANTS))
    return env


def _cta_constants(d: int, wg: int) -> dict:
    """dkv_cta's constexprs SPLIT, QW, CW at (d, wg), evaluated from the source."""
    env = {"D": d, "WG": wg, "BLOCK": CONSTANTS["BLOCK"]}
    for name in ("SPLIT", "QW", "CW"):
        expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", DKV_CTA).group(1)
        env[name] = eval(_ternary(_py(expr)), {}, env)
    return env


PLAN_LINES = [_declarations(DKV_CTA, first) for first in ("n_qt", "kt", "n_it", "k0")]


def source_plan(d: int):
    """dkv_cta's own split, evaluated: for warpgroup w of CTA x, its key tile
    kt, its first query tile, its count of steps, and its query columns (q_off)
    and output columns (c0)."""
    cta = _cta_constants(d, CONSTANTS[f"DKV_WG_{d}"])

    def plan(x, w, q_len, kv_len, causal):
        env = dict(cta, bx=x, wg=w, q_len=q_len, kv_len=kv_len, causal=int(causal), min=min, max=max)
        for line in PLAN_LINES:
            for name, expr in line:
                env[name] = eval(expr, {}, env)
        return {k: env[k] for k in ("kt", "first", "n_it", "n_qt", "q_off", "c0")}
    return plan


def computed(plan: dict) -> list:
    """The query tiles a warpgroup computes: every step of its CTA's."""
    return [plan["first"] + it for it in range(plan["n_it"])]


def launch_grid_x(d: int, kv_len: int) -> int:
    """launch_bwd_dkv's grid.x, evaluated from the source."""
    body = _body(FLASH, "cudaError_t launch_bwd_dkv(")
    grid_x = re.search(r"const dim3 grid\((.+), batch_heads\);", body).group(1)
    return eval(_py(grid_x), {}, {"kv_len": kv_len, "BLOCK": 64})


def sw128_offset(row: int, col: int) -> int:
    """The source's sm90::sw128_offset, evaluated."""
    expr = re.search(r"return ([^;]+);", _body(SM90, "uint32_t sw128_offset(")).group(1)
    return eval(_py(expr), {}, {"row": row, "col": col})


def fragment(wg_cols: int):
    """(thread, register r, row, column) of a warpgroup's m64n{wg_cols}k16 f32
    accumulator: d[4 j + 2 i + c] = (16 warp + lane / 4 + 8 i, 8 j + 2 (lane % 4) + c)."""
    for t in range(128):
        for j in range(wg_cols // 8):
            for i in range(2):
                for c in range(2):
                    yield t, 4 * j + 2 * i + c, 16 * (t // 32) + (t % 32) // 4 + 8 * i, 8 * j + 2 * (t % 4) + c


# ---------------------------------------------------------------------------
# Shared memory, constants, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", (64, 96, 128, 256))
def test_shared_memory_is_aligned_and_fits(d):
    """DkvSmem<d>: K, V, two Q and dO stages and at 256 the exchange panels,
    each at a multiple of the swizzle's period (1024 bytes; 512 for the
    64-byte swizzle at 96), none overlapping, within the 227 KB a CTA may
    have (at 256 ~210 KB); at 96 three CTAs fit an SM (~74 KB each); the
    barriers last; at 64 and 128 the offsets of the template's own body as
    they were before dkv_cta (tiles of panels(d) 64-column panels, nothing
    between dO and lse)."""
    smem = dkv_smem(d)
    tile = 64 * d * 2 if d == 96 else -(-d // PANEL) * PANEL_BYTES
    assert smem["TILE"] == tile and (smem["V"], smem["Q"]) == (tile, 2 * tile)
    bases = ([smem["K"], smem["V"]] + [smem["Q"] + s * tile for s in range(smem["STAGES"])]
             + [smem["DO"] + s * tile for s in range(smem["STAGES"])])
    ends = [b + tile for b in bases]
    if d == 256:
        x = [smem["XP"] + p * PANEL_BYTES for p in range(2)]
        bases, ends = bases + x, ends + [b + PANEL_BYTES for b in x]
        assert smem["XP"] % 1024 == 0 and smem["LSE"] == smem["XP"] + 2 * PANEL_BYTES
    else:
        assert smem["LSE"] == smem["XP"] == smem["DO"] + 2 * tile
    period = 512 if d == 96 else 1024
    assert all(b % period == 0 for b in bases)
    spans = sorted(zip(bases, ends))
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:])) and spans[0][0] == 0
    assert smem["LSE"] == max(ends) and smem["BAR"] == smem["DELTA"] + 256 * smem["STAGES"]
    assert smem["ALLOC"] == smem["BAR"] + 8 * (1 + smem["STAGES"]) + 1024  # the K/V barrier, one a stage
    assert smem["ALLOC"] <= SMEM_PER_CTA
    if d == 96:
        assert 3 * (smem["ALLOC"] + 1024) <= SMEM_PER_SM


def test_launcher_and_kernel_take_dkv_cta_at_96_and_256():
    """flash_attn_bwd_dkv at 96 and 256 goes to launch_bwd_dkv<d, DKV_WG_d>,
    whose grid has a CTA a key tile, and both instantiations are explicit
    specializations that run dkv_cta (one warpgroup at 96, two at 256); at
    64 and 128 the template's own body runs, on the same grid."""
    entry = _body(FLASH, 'extern "C" cudaError_t flash_attn_bwd_dkv(')
    for d in (96, 256):
        assert re.search(rf"case {d}:\s*return launch_bwd_dkv<{d}, DKV_WG_{d}>\(", entry)
        assert re.search(rf"flash_bwd_dkv_kernel<{d}, DKV_WG_{d}>\([^{{]*\{{\s*dkv_cta<{d}, DKV_WG_{d}>\(", FLASH)
    assert (CONSTANTS["DKV_WG_96"], CONSTANTS["DKV_WG_128"], CONSTANTS["DKV_WG_256"]) == (1, 1, 2)
    for kv_len in (1, 64, 65, 336, 577):
        assert launch_grid_x(256, kv_len) == launch_grid_x(96, kv_len) == -(-kv_len // 64)


def test_new_wgmma_wrappers_name_their_registers_in_order():
    """wgmma_ss_n32 (m64n32k16, both K-major: transposes 0, 0) names 16
    accumulators, then the two descriptors and the scale-d predicate;
    wgmma_ss_n128 (m64n128k16, B MN-major: transposes 0, 1) names 64, then
    the same three; fence_proxy_async is the async-proxy fence of shared
    memory."""
    for name, n, regs in (("wgmma_ss_n32", 32, 16), ("wgmma_ss_n128", 128, 64)):
        body = _body(SM90, f"void {name}(")
        assert f"m64n{n}k16.f32.bf16.bf16" in body
        lst = re.search(rf"#define SM90_D{regs}_LIST (.*?)(?=\n#define|\n\n)", SM90, re.S).group(1)
        assert re.findall(r"%(\d+)", lst) == [str(i) for i in range(regs)]
        tail = [int(x) for x in re.findall(r"%(\d+)", body.split(f"SM90_D{regs}_LIST")[1])]
        assert tail == [regs, regs + 1]
        assert re.search(rf"setp\.ne\.b32 p, %{regs + 2}, 0", body)
        assert ("p, 1, 1, 0, 0;" if n == 32 else "p, 1, 1, 0, 1;") in body
    assert "fence.proxy.async.shared::cta" in _body(SM90, "void fence_proxy_async(")


# ---------------------------------------------------------------------------
# The split of the work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_each_score_element_is_formed_by_one_warpgroup_at_256(causal):
    """At 256 both warpgroups of a CTA take its key tile and every step
    (causal: from the key tile's diagonal); each forms S^T and dP^T for its
    QW = 32 queries from q_off = 32 w, so over the two warpgroups'
    accumulator fragments each (key, query) element of the 64 x 64 tile is
    formed exactly once; each owns CW = 128 output columns from c0 = 128 w,
    together all 256."""
    plan = source_plan(256)
    cta = _cta_constants(256, 2)
    assert cta["SPLIT"] and (cta["QW"], cta["CW"]) == (32, 128)
    for q_len in (1, 65, 336):
        for x in range(launch_grid_x(256, q_len)):
            p = [plan(x, w, q_len, q_len, causal) for w in range(2)]
            assert p[0]["kt"] == p[1]["kt"] == x
            assert computed(p[0]) == computed(p[1]) == list(range(x if causal else 0, p[0]["n_qt"]))
            formed = [(row, p[w]["q_off"] + col) for w in range(2) for _, _, row, col in fragment(cta["QW"])]
            assert sorted(formed) == [(r, q) for r in range(64) for q in range(64)]
            assert sorted(p[w]["c0"] + c for w in range(2) for c in range(cta["CW"])) == list(range(256))


@pytest.mark.parametrize("causal", [True, False])
def test_each_key_tile_has_one_cta_at_96(causal):
    """At 96 each key tile of the launch grid belongs to the one warpgroup of
    one CTA, which forms its whole 64 x 64 S^T and dP^T, owns all 96 columns
    and computes exactly the query tiles it needs (causal: from its
    diagonal)."""
    plan = source_plan(96)
    cta = _cta_constants(96, 1)
    assert not cta["SPLIT"] and (cta["QW"], cta["CW"]) == (64, 96)
    for t in (1, 64, 65, 130, 320, 336):
        owners = []
        for x in range(launch_grid_x(96, t)):
            p = plan(x, 0, t, t, causal)
            assert p["q_off"] == p["c0"] == 0
            owners.append(p["kt"])
            assert computed(p) == list(range(p["kt"] if causal else 0, p["n_qt"]))
        assert sorted(owners) == list(range(-(-t // 64)))


# ---------------------------------------------------------------------------
# The layout through the model
# ---------------------------------------------------------------------------

def exchange_panel(base: int) -> dict:
    """One exchange panel as dkv_cta writes it at 256: for each warpgroup w
    and each pair of its accumulator fragment, the two bf16 of (key, q_off +
    column) at base + sw128_offset(key, q_off + column) (+ 2 for the second),
    both bytes of each."""
    assert "sm90::sw128_offset(row, q_off + col0)" in DKV_CTA
    assert "sm90::sw128_offset(warp * 16 + lane / 4 + 8 * i, q_off + col0)" in DKV_CTA
    smem: dict = {}
    for w in range(2):
        q_off = 32 * w
        for _, r, row, col in fragment(32):
            if r % 2:
                continue  # the thread stores its pair c = 0, 1 as one 32-bit word
            for c in range(2):
                for byte in range(2):
                    addr = base + sw128_offset(row, q_off + col) + 2 * c + byte
                    assert addr not in smem, "two elements at one address"
                    smem[addr] = (row, q_off + col + c)
    return smem


def test_exchange_panels_are_read_as_written():
    """The P^T and dS^T panels at 256: the two warpgroups' fragment stores
    fill each 8 KB panel byte for byte, every element once, and
    desc_k_major(sX, kk) (dS^T: sX + PANEL_BYTES) reads (key, 16 kk + k) at
    each (key, k) of k-step kk, so every element once, in wgmma's order, as
    the A operand of dV += P^T dO and dK += dS^T Q."""
    smem = dkv_smem(256)
    assert "sm90::wgmma_ss_n128(dv_acc, sm90::desc_k_major(sX, kk), sm90::desc_mn_major(sDO, c0 / 64, kk));" in DKV_CTA
    assert re.search(r"sm90::wgmma_ss_n128\(dk_acc, sm90::desc_k_major\(sX \+ sm90::PANEL_BYTES, kk\),\s*"
                     r"sm90::desc_mn_major\(sQ, c0 / 64, kk\)\);", DKV_CTA)
    for panel in range(2):
        base = BASE + smem["XP"] + panel * PANEL_BYTES
        x = exchange_panel(base)
        assert sorted(x) == list(range(base, base + PANEL_BYTES))
        read_exactly_once_in_order([k_major_read(x, K_MAJOR(base, kk)) for kk in range(4)],
                                   lambda kk, r, k: (r, 16 * kk + k), 64)


def test_a_wrong_swizzle_in_the_exchange_is_caught():
    """Writing the exchange without the swizzle (chunk c of row r at c, not
    c ^ (r % 8)) makes the A descriptor read other elements."""
    base = BASE
    plain = {}
    for row in range(64):
        for col in range(64):
            for byte in range(2):
                plain[base + row * 128 + 2 * col + byte] = (row, col)
    reads = [k_major_read(plain, K_MAJOR(base, kk)) for kk in range(4)]
    assert any(reads[kk][r, k] != (r, 16 * kk + k) for kk in range(4) for r in range(64) for k in range(16))


def test_score_products_at_256_read_each_warpgroups_queries():
    """S^T and dP^T at 256: desc_k_major(sK, kk) reads (key, 16 kk + k) of K
    (V); desc_k_major(sQ + q_off * 128, kk) with 32 rows reads (q_off + n,
    16 kk + k) of Q (dO), so each warpgroup reads its own 32 rows of every
    panel once, 16 k-steps over all 256 columns."""
    assert "dkv_scores<D>(st, sK, sQ + q_off * 128);" in DKV_CTA
    assert "dkv_scores<D>(dpt, sV, sDO + q_off * 128);" in DKV_CTA
    assert re.search(r"if constexpr \(D == 256\)\s*sm90::wgmma_ss_n32\(acc, sm90::desc_k_major\(sA, kk\), "
                     r"sm90::desc_k_major\(sB, kk\), kk > 0\);", _body(FLASH, "void dkv_scores("))
    smem = dkv_smem(256)
    k_base = BASE + smem["K"]
    read_exactly_once_in_order([k_major_read(sw128_tile(k_base, 256), K_MAJOR(k_base, kk)) for kk in range(16)],
                               lambda kk, r, k: (r, 16 * kk + k), 256)
    q_base = BASE + smem["Q"] + smem["TILE"]
    q_tile = sw128_tile(q_base, 256)
    seen = []
    for w in range(2):
        q_off = 32 * w
        for kk in range(16):
            got = k_major_read(q_tile, K_MAJOR(q_base + q_off * 128, kk), rows=32)
            assert all(got[n, k] == (q_off + n, 16 * kk + k) for n, k in np.ndindex(got.shape))
            seen += list(got.flat)
    assert sorted(seen) == [(r, c) for r in range(64) for c in range(256)]


def test_dkv_products_at_256_read_each_warpgroups_columns():
    """dV += P^T dO and dK += dS^T Q at 256: desc_mn_major(sDO, c0 / 64, kk)
    over N = 128 reads (16 kk + k, c0 + n) across two panels (LBO), so the
    two warpgroups together read every element of dO (Q) once."""
    smem = dkv_smem(256)
    base = BASE + smem["DO"]
    tile = sw128_tile(base, 256)
    seen = []
    for w in range(2):
        c0 = 128 * w
        for kk in range(4):
            got = mn_major_read(tile, MN_MAJOR(base, c0 // 64, kk), 128)
            assert all(got[k, n] == (16 * kk + k, c0 + n) for k, n in np.ndindex(got.shape))
            seen += list(got.flat)
    assert sorted(seen) == [(r, c) for r in range(64) for c in range(256)]


def test_tiles_at_96_are_read_once_by_every_product():
    """At 96 load_tile<96> writes each K, V, Q and dO tile of DkvSmem<96>
    once (three 32-column boxes, nothing past column 95); S^T and dP^T read K
    and Q (V and dO) K-major in 6 k-steps of desc_k_major_sw64, and dV += P^T
    dO, dK += dS^T Q read dO and Q MN-major in 4 k-steps of m64n96k16
    (desc_mn_major_sw64), every element once."""
    assert "sm90::wgmma_rs_n96(dv_acc, pa[kk], sm90::desc_mn_major_sw64(sDO, kk))" in DKV_CTA
    assert "sm90::wgmma_rs_n96(dk_acc, dsa[kk], sm90::desc_mn_major_sw64(sQ, kk))" in DKV_CTA
    assert re.search(r"load_tile<D>\(smem \+ L::Q \+ s \* L::TILE, tm_q,", DKV_CTA)
    assert re.search(r"if constexpr \(D == 96\)\s*return sm90::desc_k_major_sw64\(tile, kk\);",
                     _body(FLASH, "uint64_t desc_k("))
    smem = dkv_smem(96)
    for name in ("K", "V", "Q", "DO"):
        base = BASE + smem[name]
        tile = sw64_tile(base)
        assert sorted(tile) == list(range(base, base + smem["TILE"])) and None not in tile.values()
        read_exactly_once_in_order([k_major_read(tile, K_MAJOR_SW64(base, kk)) for kk in range(6)],
                                   lambda kk, r, k: (r, 16 * kk + k), 96)
        if name in ("Q", "DO"):
            read_exactly_once_in_order([mn_major_read(tile, MN_MAJOR_SW64(base, kk), 96) for kk in range(4)],
                                       lambda kk, k, n: (16 * kk + k, n), 96)


# ---------------------------------------------------------------------------
# dK and dV through the model
# ---------------------------------------------------------------------------

def _split(reads):
    return [(np.vectorize(lambda x: x[0])(r), np.vectorize(lambda x: x[1])(r)) for r in reads]


def operand_maps(d: int) -> dict:
    """Index arrays (rows, cols) of what each k-step reads, from the model: the
    score products' K (V) and each warpgroup's Q (dO) rows; dV's and dK's dO
    (Q) columns of each warpgroup; at 256 the exchange panel as the A operand."""
    smem = dkv_smem(d)
    if d == 96:
        k_base, q_base = BASE + smem["K"], BASE + smem["Q"]
        k_tile, q_tile = sw64_tile(k_base), sw64_tile(q_base)
        return {"k": _split([k_major_read(k_tile, K_MAJOR_SW64(k_base, kk)) for kk in range(6)]),
                "q": [_split([k_major_read(q_tile, K_MAJOR_SW64(q_base, kk)) for kk in range(6)])],
                "b": [_split([mn_major_read(q_tile, MN_MAJOR_SW64(q_base, kk), 96) for kk in range(4)])]}
    k_base, q_base, x_base = BASE + smem["K"], BASE + smem["Q"], BASE + smem["XP"]
    k_tile, q_tile, x = sw128_tile(k_base, d), sw128_tile(q_base, d), exchange_panel(x_base)
    return {"k": _split([k_major_read(k_tile, K_MAJOR(k_base, kk)) for kk in range(16)]),
            "q": [_split([k_major_read(q_tile, K_MAJOR(q_base + 32 * w * 128, kk), rows=32) for kk in range(16)])
                  for w in range(2)],
            "b": [_split([mn_major_read(q_tile, MN_MAJOR(q_base, 2 * w, kk), 128) for kk in range(4)])
                  for w in range(2)],
            "x": _split([k_major_read(x, K_MAJOR(x_base, kk)) for kk in range(4)])}


def emulated_dkv(q, k, v, g, mask, lse, delta, causal: bool, scale: float, d: int):
    """dk, dv of flash_bwd_dkv_kernel<d> with every operand read through the
    model: dkv_cta's own split of key tiles, warpgroups and query columns
    (source_plan), the ring's query tiles (zeros past the end, as TMA fills
    them), P^T =
    keep ? 2^(s^T scale log2 e - lse log2 e) : 0 and dS^T = P^T (dP^T - delta)
    in f32, both rounded to bf16 for their products; at 256 through the
    exchange panel's reads."""
    maps = operand_maps(d)
    plan = source_plan(d)
    wg = CONSTANTS[f"DKV_WG_{d}"]
    cta = _cta_constants(d, wg)
    b_, h_, q_len, _ = q.shape
    kv_len = k.shape[2]
    dk, dv = np.zeros(k.shape, np.float32), np.zeros(v.shape, np.float32)

    def tile(x, t, n):  # rows 64 t .. 64 t + 63 of a length-n axis, zeros past n
        out = np.zeros((64,) + x.shape[1:], x.dtype)
        part = x[64 * t:min(64 * t + 64, n)]
        out[:len(part)] = part
        return out

    def scores(a_tile, b_tile, u):  # S^T or dP^T of warpgroup u's query columns
        return sum(a_tile[r, c] @ b_tile[qr, qc].T for (r, c), (qr, qc) in zip(maps["k"], maps["q"][u]))

    for b in range(b_):
        keep_key = np.zeros(-(-kv_len // 64) * 64, bool)
        keep_key[:kv_len] = mask[b] > 0
        for h in range(h_):
            lse_log2 = np.full(-(-q_len // 64) * 64, np.inf, np.float32)
            lse_log2[:q_len] = lse[b, h] * LOG2E
            dlt = np.zeros_like(lse_log2)
            dlt[:q_len] = delta[b, h]
            for x in range(launch_grid_x(d, kv_len)):
                for w in range(wg):
                    p = plan(x, w, q_len, kv_len, causal)
                    kt = p["kt"]
                    ktile, vtile = tile(k[b, h], kt, kv_len), tile(v[b, h], kt, kv_len)
                    acc_k = np.zeros((64, cta["CW"]), np.float32)
                    acc_v = np.zeros((64, cta["CW"]), np.float32)
                    for qt in computed(p):
                        qtile, gtile = tile(q[b, h], qt, q_len), tile(g[b, h], qt, q_len)
                        # every warpgroup's query columns (at 96 the one warpgroup's 64)
                        parts = range(2) if cta["SPLIT"] else [0]
                        st = np.concatenate([scores(ktile, qtile, u) for u in parts], axis=1)
                        dpt = np.concatenate([scores(vtile, gtile, u) for u in parts], axis=1)
                        keep = np.broadcast_to(keep_key[64 * kt:64 * kt + 64, None], (64, 64)).copy()
                        if causal and qt == kt:
                            keep &= np.triu(np.ones((64, 64), bool))  # key row <= query column
                        cols = slice(64 * qt, 64 * qt + 64)
                        pt = np.where(keep, np.exp2(st.astype(np.float32) * np.float32(scale * LOG2E)
                                                    - lse_log2[cols][None, :]), 0).astype(np.float32)
                        dst = (pt * (dpt.astype(np.float32) - dlt[cols][None, :])).astype(np.float32)
                        pb, db = _bf16(pt), _bf16(dst)
                        if cta["SPLIT"]:  # A from the exchange panels: (key, query) at each (kk, key, k)
                            a_p = [pb[r, c] for r, c in maps["x"]]
                            a_d = [db[r, c] for r, c in maps["x"]]
                        else:  # A from registers: columns 16 kk .. 16 kk + 15
                            a_p = [pb[:, 16 * kk:16 * kk + 16] for kk in range(4)]
                            a_d = [db[:, 16 * kk:16 * kk + 16] for kk in range(4)]
                        bmap = maps["b"][w if cta["SPLIT"] else 0]
                        acc_v += sum(a @ gtile[r, c] for a, (r, c) in zip(a_p, bmap))
                        acc_k += sum(a @ qtile[r, c] for a, (r, c) in zip(a_d, bmap))
                    rows = slice(64 * kt, min(64 * kt + 64, kv_len))
                    n = rows.stop - rows.start
                    out = slice(p["c0"], p["c0"] + cta["CW"])
                    dv[b, h, rows, out] = acc_v[:n]
                    dk[b, h, rows, out] = acc_k[:n] * np.float32(scale)
    return dk, dv


# (batch, heads, q_len, kv_len, causal, masked key range, all-masked last sample): 1, 3 and 5 query tiles
DKV_CASES = {
    "causal_20_one_tile_empty_rows": (2, 1, 20, 20, True, (0, 3), True),
    "causal_130_three_tiles": (1, 2, 130, 130, True, (0, 7), False),
    "causal_320_five_tiles": (1, 1, 320, 320, True, (256, 272), False),
    "noncausal_130_three_tiles": (1, 1, 130, 130, False, (100, 140), False),
    "noncausal_65_by_200_masked": (2, 1, 65, 200, False, (150, 200), False),
}


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(DKV_CASES))
def test_emulated_dkv_matches_pallas(d, case):
    """dk and dv through the model, with dkv_cta's own control flow, against
    the JAX package's Pallas dK/dV kernel (interpret mode) at bf16, from the
    Pallas forward's o and lse: within the card's bf16 tolerance (atol =
    rtol = 2e-2); the keys of the all-masked sample get dk = dv = 0 in both."""
    b, h, tq, tk, causal, masked, empty = DKV_CASES[case]
    rng = np.random.default_rng(22)
    q, g = (_bf16(rng.normal(size=(b, h, tq, d))) for _ in range(2))
    k, v = (_bf16(rng.normal(size=(b, h, tk, d))) for _ in range(2))
    mask = np.ones((b, tk), np.int32)
    mask[:, masked[0]:masked[1]] = 0
    if empty:
        mask[-1] = 0
    scale = d ** -0.5
    prev = jattn._INTERPRET
    jattn._INTERPRET = True
    try:
        args = [jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)] + [jnp.asarray(mask)]
        o, lse = jattn._flash_forward(*args, causal=causal, scale=scale, block_q=64, block_k=64, use_mask=True)
        _, ref_dk, ref_dv = jattn._flash_backward(*args, o, lse, jnp.asarray(g, dtype=jnp.bfloat16), causal=causal,
                                                  scale=scale, block_q=64, block_k=64, use_mask=True)
    finally:
        jattn._INTERPRET = prev
    o, lse = np.asarray(o, dtype=np.float32), np.asarray(lse, dtype=np.float32)
    delta = (g * o).sum(-1, dtype=np.float32)
    dk, dv = emulated_dkv(q, k, v, g, mask, lse, delta, causal, scale, d)
    np.testing.assert_allclose(_bf16(dk), np.asarray(ref_dk, np.float32), atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(_bf16(dv), np.asarray(ref_dv, np.float32), atol=ATOL, rtol=RTOL, err_msg="dv")
    if empty:
        assert (dk[-1] == 0).all() and (dv[-1] == 0).all()
