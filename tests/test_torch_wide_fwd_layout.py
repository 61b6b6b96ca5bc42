"""The bf16 wide forward (`flash_fwd_wide_kernel<512>`, every multiple of 128
from 384 on: mafed_tpu_torch/csrc/flash_attn.cu), emulated on the CPU with
the model of TMA and wgmma in tests/test_torch_d96_layout.py.

A CTA owns one 64-row query tile and one piece of up to 512 output columns,
one warpgroup for each 128-column slice of its piece (3 at 384, 4 at 512).
Warpgroup w forms the partial score tile S_w = Q[:, slice w] K[:, slice w]^T
over its slice's two 64-column panels (up to 512 columns in two halves of
32 keys, 8 k-steps of m64n32k16 each; past 512, 8 k-steps of m64n64k16 a
round), writes its accumulator registers in fragment order into its own K
slice (`wide_xchg`: the first half's into K rows the second half's products
do not read), and after a barrier every warpgroup sums the partials at its own fragment
positions, slice 0 first, so that all hold the same S; O_w += P V[:, slice w]
is one m64n128k16 a k-step, V MN-major across the slice's two panels. Past
512 columns D is cut into pieces, each CTA forms S over all of D in rounds
of W slices, and the pieces of a tile each form it again.

Read from the sources and checked here: the launcher's pieces and warpgroups
and the kernel's own slice arithmetic (every output column of D from 384 to
2048 owned by one warpgroup of one CTA; at 384 and 512 one piece and one
round, so each score element is formed once a CTA and Q is loaded once);
`WideFwdSmem` (aligned, within the 232,448 B a CTA may have at 384 and 512,
the exchange inside K's slices); the exchange's addresses (each partial
element written once, read back once by each thread in slice order, one
bank per thread of a warp); the fixed-order sum (bit-identical S in every
warpgroup, emulated in float32, where another order is not); the score and
P V descriptors through the model. The forward run through the model with
that control flow matches the JAX package's Pallas forward in interpret mode.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp

from mafed_tpu.kernels import attention as jattn
from mafed_tpu_torch.kernels import build

from test_torch_d96_layout import (BASE, FLASH, LSE_ATOL, _SM90_CONSTANTS, _bf16, _body, _constants,
                                   _descriptor_maker, _map_box_and_swizzle, _py, k_major_read, mn_major_read,
                                   tma_write)
from test_torch_fwd_layout import SMEM_PER_CTA, _declarations

ATOL = RTOL = 2e-2  # bf16 outputs, as the card's kernel checks
PANEL_BYTES = _SM90_CONSTANTS["PANEL_BYTES"]
K_MAJOR, MN_MAJOR = _descriptor_maker("desc_k_major"), _descriptor_maker("desc_mn_major")
CONSTANTS = _constants(FLASH, ("BLOCK", "WIDE_SLICE", "WIDE_FWD_PIECE", "WIDE_FWD_WG"))
THREADS = 128
KERNEL = _body(FLASH, "flash_fwd_wide_kernel(")
LAUNCHER = _body(FLASH, "cudaError_t launch_fwd_wide(")
WIDE_HEAD_DIMS = list(range(384, 2049, 128))


def wide_smem() -> dict:
    """WideFwdSmem's byte offsets, evaluated from the source."""
    env = dict(CONSTANTS, THREADS=THREADS)
    for name, expr in re.findall(r"static constexpr \w+ (\w+) = ([^;]+);", _body(FLASH, "struct WideFwdSmem")):
        env[name] = eval(_py(expr), {}, dict(env, **_SM90_CONSTANTS))
    return env


def launch(d: int) -> dict:
    """launch_fwd_wide's pieces and warpgroups a CTA at head_dim d, evaluated from the source."""
    env = dict(CONSTANTS, d=d)
    for first in ("slices", "wgs"):
        for name, expr in _declarations(LAUNCHER, first):
            env[name] = eval(expr, {}, dict(env, min=min))
    grid = re.search(r"const dim3 grid\((\w+), \(q_len \+ BLOCK - 1\) / BLOCK, batch_heads\);", LAUNCHER)
    assert grid and "<<<grid, THREADS * wgs, smem, stream>>>" in LAUNCHER
    return {"pieces": env[grid.group(1)], "wgs": env["wgs"], "slices": env["slices"]}


CTA_LINES = [_declarations(KERNEL, first) for first in ("nwg", "n_sl", "piece", "sl")]


def cta(d: int, piece: int, wg: int) -> dict:
    """The kernel's own index arithmetic for warpgroup wg of the CTA of piece `piece`: W (nwg), the slices
    of D, the score rounds and the warpgroup's output slice, evaluated from the source."""
    shape = launch(d)
    env = dict(CONSTANTS, THREADS=THREADS, d=d, bx=piece, wg=wg, heads=1, min=min,
               blockDim=SimpleNamespace(x=THREADS * shape["wgs"]), blockIdx=SimpleNamespace(y=0, z=0))
    for line in CTA_LINES:
        for name, expr in line:
            env[name] = eval(expr, {}, env)
    return {k: env[k] for k in ("nwg", "n_sl", "rounds", "piece", "sl")}


def score_slices(plan: dict, wg: int) -> list:
    """The slices of D whose score product warpgroup wg forms, round by round (the kernel's `r * nwg + wg < n_sl`)."""
    return [r * plan["nwg"] + wg for r in range(plan["rounds"]) if r * plan["nwg"] + wg < plan["n_sl"]]


# ---------------------------------------------------------------------------
# The split of the work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_pieces_and_slices_cover_each_output_column_once(d):
    """Over the launcher's grid at D = 384 .. 2048: at most WIDE_FWD_WG
    warpgroups a CTA, ceil(D / 512) pieces (build.route's count), every
    output column owned by exactly one warpgroup of one piece, no CTA
    without a slice; each CTA forms S over all of D, each slice of D by one
    warpgroup."""
    shape = launch(d)
    assert shape["pieces"] == -(-d // 512) == build.route("flash_fwd", "bfloat16", d).slices
    assert shape["wgs"] <= CONSTANTS["WIDE_FWD_WG"] == 4 and shape["wgs"] * shape["pieces"] >= d // 128
    owners = []
    for piece in range(shape["pieces"]):
        mine = []
        for wg in range(shape["wgs"]):
            plan = cta(d, piece, wg)
            assert plan["nwg"] == shape["wgs"] and plan["n_sl"] == d // 128
            if plan["sl"] < plan["n_sl"]:
                mine += range(128 * plan["sl"], 128 * plan["sl"] + 128)
        assert mine, f"piece {piece} has no slice"
        owners += mine
        formed = sorted(s for wg in range(shape["wgs"]) for s in score_slices(cta(d, piece, wg), wg))
        assert formed == list(range(d // 128))
    assert sorted(owners) == list(range(d))


@pytest.mark.parametrize("d", [384, 512])
def test_each_score_element_is_formed_once_a_cta_and_q_loaded_once(d):
    """At 384 and 512: one piece, so one CTA a query tile; one round, each
    slice of D's score product formed by one warpgroup, which reads columns
    128 w .. 128 w + 127 of Q and K through its descriptors (so each score
    element's sum over D is formed once); Q's slices loaded once, before
    the key loop, and K's each key tile."""
    shape = launch(d)
    assert shape["pieces"] == 1 and shape["wgs"] == d // 128
    plans = [cta(d, 0, wg) for wg in range(shape["wgs"])]
    assert all(p["rounds"] == 1 for p in plans)
    assert [score_slices(p, wg) for wg, p in enumerate(plans)] == [[wg] for wg in range(d // 128)]
    assert ("sm90::wgmma_ss_n32(sh, sm90::desc_k_major(sQw, kk), sm90::desc_k_major(sKw + h * 4096, kk), kk > 0);"
            in KERNEL)
    smem = wide_smem()
    for wg in range(shape["wgs"]):
        base = BASE + smem["Q"] + wg * smem["SLICE"]
        tile = slice_tile(base, wg, d)
        for kk in range(8):
            got = k_major_read(tile, K_MAJOR(base, kk))
            assert all(got[r, k] == (r, 128 * wg + 16 * kk + k) for r, k in np.ndindex(got.shape))
        base = BASE + smem["K"] + wg * smem["SLICE"]
        tile = slice_tile(base, wg, d)
        for h in range(2):  # the halves of 32 keys: K rows 32 h .. 32 h + 31
            for kk in range(8):
                got = k_major_read(tile, K_MAJOR(base + 4096 * h, kk), 32)
                assert all(got[r, k] == (32 * h + r, 128 * wg + 16 * kk + k) for r, k in np.ndindex(got.shape))
    assert re.search(r"if \(rounds == 1\) \{  // Q once, for the whole key loop\s*"
                     r"sm90::mbar_expect_tx\(&bar\[0\], n_sl \* L::SLICE\);\s*"
                     r"load_slices\(L::Q, mq, &bar\[0\], q0, 0, n_sl\);", KERNEL)
    assert "if (rounds > 1) load_slices(L::Q, mq, &bar[1], q0, first, n);" in KERNEL
    assert KERNEL.count("load_slices(L::Q,") == 2 and KERNEL.count("load_slices(L::K,") == 1


# ---------------------------------------------------------------------------
# Shared memory and the exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [384, 512])
def test_shared_memory_fits_a_cta(d):
    """WideFwdSmem: Q, K and V as WIDE_FWD_WG slices of 16 KB ([64][128], two
    64-column panels), each 1024-aligned, none overlapping, the keep bits,
    three barriers and each thread's m and l after them, the whole within
    232,448 B; the exchange
    (each warpgroup's 32 registers x 128 threads of f32) fills exactly its
    own K slice, so it takes no room of its own."""
    smem = wide_smem()
    assert smem["SLICE"] == 2 * PANEL_BYTES == 64 * 128 * 2
    wgs = launch(d)["wgs"]
    bases = [smem[r] + w * smem["SLICE"] for r in ("Q", "K", "V") for w in range(CONSTANTS["WIDE_FWD_WG"])]
    assert all(b % 1024 == 0 for b in bases) and len(set(bases)) == len(bases)
    spans = sorted((b, b + smem["SLICE"]) for b in bases)
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:]))
    assert smem["KEEP"] == spans[-1][1] and smem["BAR"] == smem["KEEP"] + 16
    assert smem["ML"] >= smem["BAR"] + 3 * 8 and smem["ML"] % 16 == 0  # three barriers, then a float4 a thread
    assert smem["ALLOC"] == smem["ML"] + CONSTANTS["WIDE_FWD_WG"] * THREADS * 16 + 1024 <= SMEM_PER_CTA
    assert 32 * THREADS * 4 == smem["SLICE"] and wgs * smem["SLICE"] <= smem["V"] - smem["K"]
    assert "constexpr size_t smem = WideFwdSmem::ALLOC;" in LAUNCHER


def xchg(r4: int, t: int) -> int:
    """The source's wide_xchg, evaluated."""
    expr = re.search(r"return ([^;]+);", _body(FLASH, "uint32_t wide_xchg(")).group(1)
    return eval(_py(expr.replace("(uint32_t)", "")), {}, {"r4": r4, "t": t, "THREADS": THREADS})


def exchange_writes(wgs: int) -> dict:
    """{byte offset from the K region: (warpgroup, thread, register)} of the partials' stores, as the
    kernel writes them: float4 r4 of thread t of warpgroup w at w x SLICE + wide_xchg(r4, t). Past one
    round the whole accumulator at once; in one round float4 r4 of half h's 16 registers (m64n32k16:
    registers 16 h + 4 r4 .. of the whole tile's fragment) at wide_xchg(4 h + r4, t), the same place."""
    assert re.search(r"\*reinterpret_cast<float4\*>\(xs \+ wg \* L::SLICE \+ wide_xchg\(r4, t\)\) =\s*"
                     r"make_float4\(sc\[4 \* r4\], sc\[4 \* r4 \+ 1\], sc\[4 \* r4 \+ 2\], sc\[4 \* r4 \+ 3\]\);",
                     KERNEL)
    assert re.search(r"\*reinterpret_cast<float4\*>\(xs \+ wg \* L::SLICE \+ wide_xchg\(4 \* h \+ r4, t\)\) =\s*"
                     r"make_float4\(sh\[4 \* r4\], sh\[4 \* r4 \+ 1\], sh\[4 \* r4 \+ 2\], sh\[4 \* r4 \+ 3\]\);",
                     KERNEL)
    smem, out = wide_smem(), {}
    for w in range(wgs):
        for t in range(THREADS):
            for r4 in range(8):
                for c in range(4):
                    addr = w * smem["SLICE"] + xchg(r4, t) + 4 * c
                    assert addr not in out, "two partial elements at one address"
                    out[addr] = (w, t, 4 * r4 + c)
    return out


def exchange_reads(t: int, wgs: int) -> list:
    """The byte offsets, in order, from which a thread t of any warpgroup reads each float4 r4 to sum S:
    partial 0's, then each later warpgroup's (the kernel's loop)."""
    assert "float4 s = *reinterpret_cast<const float4*>(xs + wide_xchg(r4, t));" in KERNEL
    assert re.search(r"for \(int w = 1; w < WIDE_FWD_WG; \+\+w\) \{\s*if \(w < nwg\) \{\s*"
                     r"const float4 x = \*reinterpret_cast<const float4\*>\(xs \+ w \* L::SLICE \+ "
                     r"wide_xchg\(r4, t\)\);", KERNEL)
    smem = wide_smem()
    return [[w * smem["SLICE"] + xchg(r4, t) for w in range(wgs)] for r4 in range(8)]


@pytest.mark.parametrize("d", [384, 512])
def test_exchange_reads_back_each_partial_once_in_slice_order(d):
    """Every partial element is written once, inside its warpgroup's own K
    slice; thread t of every warpgroup reads back, for each of its 32
    registers, exactly the elements (w, t, r) of every warpgroup w, in the
    order w = 0, 1, ..., so each partial element once and slice 0 first;
    the 32 threads of a warp touch 32 consecutive 16-byte words (no bank
    twice in a phase)."""
    wgs = launch(d)["wgs"]
    writes = exchange_writes(wgs)
    smem = wide_smem()
    assert all(w * smem["SLICE"] <= a < (w + 1) * smem["SLICE"] for a, (w, _, _) in writes.items())
    assert len(writes) == wgs * THREADS * 32 and max(writes) < wgs * smem["SLICE"]
    for t in range(THREADS):
        seen = []
        for r4, addrs in enumerate(exchange_reads(t, wgs)):
            for c in range(4):
                got = [writes[a + 4 * c] for a in addrs]
                assert got == [(w, t, 4 * r4 + c) for w in range(wgs)]
                seen += got
        assert len(seen) == len(set(seen)) == 32 * wgs
    for warp in range(4):
        words = sorted(xchg(r4, t) for t in range(32 * warp, 32 * warp + 32) for r4 in [3])
        assert words == [words[0] + 16 * i for i in range(32)]


def test_first_half_is_written_over_keys_the_second_half_no_longer_reads():
    """In one round each warpgroup writes its first half's partial (float4s
    0..3, as soon as that half's products have completed) only over K's
    rows 0..31 of its slice, which the second half's products (rows 32..63
    through desc_k_major(sKw + 4096, kk)) do not read; the second half's
    partial goes over rows 32..63 once its own products have completed."""
    assert re.search(r"for \(int h = 0; h < 2; \+\+h\) \{.*?sm90::wgmma_ss_n32\(.*?sm90::wgmma_commit\(\);\s*"
                     r"sm90::wgmma_wait<0>\(\);\s*sm90::fence_regs\(sh\);\s*#pragma unroll\s*"
                     r"for \(int r4 = 0; r4 < 4; \+\+r4\)\s*\*reinterpret_cast<float4\*>\(xs \+ wg \* L::SLICE \+ "
                     r"wide_xchg\(4 \* h \+ r4, t\)\)", KERNEL, re.S)
    smem = wide_smem()
    for wg in range(CONSTANTS["WIDE_FWD_WG"]):
        base = BASE + smem["K"] + wg * smem["SLICE"]
        tile = slice_tile(base, wg, 512)
        second = set()
        for kk in range(8):
            second |= set(k_major_read(tile, K_MAJOR(base + 4096, kk), 32).ravel())
        assert len(second) == 32 * 128 and all(r >= 32 for r, _ in second)
        for t in range(THREADS):
            for r4 in range(8):
                rows = {tile[base + xchg(r4, t) + b][0] for b in range(0, 16, 2)}
                assert rows <= (set(range(32)) if r4 < 4 else set(range(32, 64)))


@pytest.mark.parametrize("d", [384, 512])
def test_fixed_order_sum_gives_every_warpgroup_the_same_scores(d):
    """Emulated in float32: partials of widely spread magnitudes written to
    the exchange as the kernel writes them, summed by each warpgroup as the
    kernel reads them (slice 0 first): every warpgroup's S is the same bit
    for bit, and equals the sum in slice order; each warpgroup starting from
    its own partial (an order that depends on the warpgroup) would not
    agree."""
    wgs = launch(d)["wgs"]
    rng = np.random.default_rng(23)
    partials = (rng.normal(size=(wgs, THREADS, 32)) * 10.0 ** rng.integers(-3, 4, size=(wgs, THREADS, 32)))
    partials = partials.astype(np.float32)
    memory = {a: partials[w, t, r] for a, (w, t, r) in exchange_writes(wgs).items()}
    sums = np.zeros((wgs, THREADS, 32), np.float32)
    for w in range(wgs):  # every warpgroup runs the same reads at its thread's positions
        for t in range(THREADS):
            for r4, addrs in enumerate(exchange_reads(t, wgs)):
                for c in range(4):
                    s = np.float32(memory[addrs[0] + 4 * c])
                    for a in addrs[1:]:
                        s = np.float32(s + memory[a + 4 * c])
                    sums[w, t, 4 * r4 + c] = s
    assert all(np.array_equal(sums[0].view(np.uint32), sums[w].view(np.uint32)) for w in range(wgs))
    in_order = partials[0].copy()
    for w in range(1, wgs):
        in_order = (in_order + partials[w]).astype(np.float32)
    assert np.array_equal(sums[0].view(np.uint32), in_order.view(np.uint32))
    own_first = []
    for w in range(wgs):
        s = partials[w].copy()
        for u in range(wgs):
            if u != w:
                s = (s + partials[u]).astype(np.float32)
        own_first.append(s)
    assert any(not np.array_equal(own_first[0].view(np.uint32), x.view(np.uint32)) for x in own_first[1:])


# ---------------------------------------------------------------------------
# The products through the model
# ---------------------------------------------------------------------------

def slice_tile(base: int, s: int, d: int) -> dict:
    """Slice s ([64][128]) of a [64][d] tile at `base`, as the kernel's load_slices loads it: two boxes of
    make_map_3d's {64, 64} at columns 128 s and 128 s + 64, 8 KB apart."""
    box, swizzle = _map_box_and_swizzle("make_map_3d")
    assert re.search(r"sm90::tma_load_3d\(smem \+ dst \+ i \* L::SLICE \+ p \* sm90::PANEL_BYTES, m, br,\s*"
                     r"\(first \+ i\) \* WIDE_SLICE \+ 64 \* p, row, bh\);", KERNEL)
    smem: dict = {}
    for p in range(2):
        tma_write(smem, base + p * PANEL_BYTES, 128 * s + 64 * p, box[0], swizzle, cols=d)
    return smem


def test_products_read_their_slice_as_the_model_says():
    """The score products of warpgroup w: desc_k_major(sQw / sKw, kk), kk <
    8, read (row, 128 s + 16 kk + k) of slice s, every element once; P V:
    desc_mn_major(sVw, 0, kk) in one m64n128k16 (wgmma_rs_n128) reads (16
    kk + k, 128 s + n) for n < 128 across the slice's two panels (LBO)."""
    assert "sm90::wgmma_ss(sc, sm90::desc_k_major(sQw, kk), sm90::desc_k_major(sKw, kk), r > 0 || kk > 0);" in KERNEL
    assert "for (int kk = 0; kk < WIDE_SLICE / 16; ++kk)" in KERNEL
    assert "sm90::wgmma_rs_n128(acc, pa[kk], sm90::desc_mn_major(sVw, 0, kk));" in KERNEL
    smem = wide_smem()
    for s in range(4):
        base = BASE + smem["V"] + s * smem["SLICE"]
        tile = slice_tile(base, s, 512)
        assert sorted(tile) == list(range(base, base + smem["SLICE"]))
        seen = []
        for kk in range(4):
            got = mn_major_read(tile, MN_MAJOR(base, 0, kk), 128)
            assert all(got[k, n] == (16 * kk + k, 128 * s + n) for k, n in np.ndindex(got.shape))
            seen += list(got.ravel())
        assert len(set(seen)) == 64 * 128


_MAPS: dict = {}


def operand_maps(s: int, d: int):
    """Index arrays (rows, cols) of what each k-step reads from slice s, from the model: the score
    product's Q and K operands (8 k-steps, K-major), P V's V (4 k-steps, MN-major, N = 128), and K's
    operands of the one-round halves (8 k-steps each of 32 rows)."""
    if (s, d) not in _MAPS:
        def split(reads):
            return [(np.vectorize(lambda x: x[0])(r), np.vectorize(lambda x: x[1])(r)) for r in reads]
        smem = wide_smem()
        slot = s % CONSTANTS["WIDE_FWD_WG"]
        qb, kb, vb = (BASE + smem[r] + slot * smem["SLICE"] for r in ("Q", "K", "V"))
        q_t, k_t, v_t = slice_tile(qb, s, d), slice_tile(kb, s, d), slice_tile(vb, s, d)
        _MAPS[s, d] = (split([k_major_read(q_t, K_MAJOR(qb, kk)) for kk in range(8)]),
                       split([k_major_read(k_t, K_MAJOR(kb, kk)) for kk in range(8)]),
                       split([mn_major_read(v_t, MN_MAJOR(vb, 0, kk), 128) for kk in range(4)]),
                       [split([k_major_read(k_t, K_MAJOR(kb + 4096 * h, kk), 32) for kk in range(8)])
                        for h in range(2)])
    return _MAPS[s, d]


def emulated_forward(q, k, v, mask, causal: bool, scale: float):
    """(o, lse) of flash_fwd_wide_kernel through the model: the launcher's pieces and warpgroups, the
    kernel's own rounds and slices (cta()), each warpgroup's partial S over its slices in float32, the
    partials summed slice 0 first, the log2-domain online softmax over 64-key tiles (masked scores
    finfo(f32).min, keep zeroing), P rounded to bf16, O of each warpgroup's slice; lse from piece 0."""
    b_, h_, q_len, d = q.shape
    kv_len = k.shape[2]
    n_qt, n_kt = -(-q_len // 64), -(-kv_len // 64)
    neg, log2e = np.float32(np.finfo(np.float32).min), np.float32(1.4426950408889634)
    shape = launch(d)
    o = np.full(q.shape, np.nan, np.float32)
    lse = np.full(q.shape[:3], np.nan, np.float32)

    def tile(x, t):  # rows 64 t .. 64 t + 63, zeros past the end (TMA's fill)
        out = np.zeros((64, d), np.float32)
        part = x[64 * t:64 * t + 64]
        out[:len(part)] = part
        return out

    for b in range(b_):
        keep_keys = np.zeros(n_kt * 64, bool)
        keep_keys[:kv_len] = mask[b] > 0
        for h in range(h_):
            for qt in range(n_qt):
                qtile = tile(q[b, h], qt)
                upper = min(qt + 1, n_kt) if causal else n_kt
                for piece in range(shape["pieces"]):
                    plans = [cta(d, piece, wg) for wg in range(shape["wgs"])]
                    acc = np.zeros((shape["wgs"], 64, 128), np.float32)
                    m = np.full(64, -np.inf, np.float32)
                    l = np.zeros(64, np.float32)
                    for kt in range(upper):
                        ktile, vtile = tile(k[b, h], kt), tile(v[b, h], kt)
                        partials = []
                        for wg, plan in enumerate(plans):
                            part = np.zeros((64, 64), np.float32)
                            if plan["rounds"] == 1:  # two halves of 32 keys
                                (s,) = score_slices(plan, wg)
                                q_maps, _, _, halves = operand_maps(s, d)
                                for half, k_maps in enumerate(halves):
                                    keys = slice(32 * half, 32 * half + 32)
                                    for (qr, qc), (kr, kc) in zip(q_maps, k_maps):
                                        part[:, keys] = (part[:, keys] + qtile[qr, qc] @ ktile[kr, kc].T)
                            else:
                                for s in score_slices(plan, wg):
                                    q_maps, k_maps, _, _ = operand_maps(s, d)
                                    for (qr, qc), (kr, kc) in zip(q_maps, k_maps):
                                        part = (part + qtile[qr, qc] @ ktile[kr, kc].T).astype(np.float32)
                            partials.append(part)
                        s_tile = partials[0]
                        for part in partials[1:]:
                            s_tile = (s_tile + part).astype(np.float32)
                        x = s_tile * np.float32(scale * log2e)
                        keep = np.broadcast_to(keep_keys[64 * kt:64 * kt + 64], (64, 64)).copy()
                        if causal and kt == qt:
                            keep &= np.tril(np.ones((64, 64), bool))
                        x = np.where(keep, x, neg)
                        m_new = np.maximum(m, x.max(axis=1))
                        alpha = np.exp2(m - m_new)
                        m_sub = np.where(m_new == neg, np.inf, m_new)
                        p = np.exp2(x - m_sub[:, None]).astype(np.float32)
                        l = l * alpha + p.sum(axis=1)
                        m = m_new
                        pb = _bf16(p)
                        for wg, plan in enumerate(plans):
                            if plan["sl"] >= plan["n_sl"]:
                                continue
                            _, _, v_maps, _ = operand_maps(plan["sl"], d)
                            acc[wg] = acc[wg] * alpha[:, None] + sum(
                                pb[:, 16 * kk:16 * kk + 16] @ vtile[vr, vc] for kk, (vr, vc) in enumerate(v_maps))
                    empty = l == 0
                    l_safe = np.where(empty, 1.0, l).astype(np.float32)
                    rows = slice(64 * qt, min(64 * qt + 64, q_len))
                    n = rows.stop - rows.start
                    for wg, plan in enumerate(plans):
                        if plan["sl"] < plan["n_sl"]:
                            cols = slice(128 * plan["sl"], 128 * plan["sl"] + 128)
                            assert np.isnan(o[b, h, rows, cols]).all(), "an output column stored twice"
                            o[b, h, rows, cols] = (acc[wg] / l_safe[:, None])[:n]
                    if piece == 0:
                        lse[b, h, rows] = np.where(empty, np.inf, m * np.float32(np.log(2)) + np.log(l_safe))[:n]
    assert not np.isnan(o).any() and not np.isnan(lse).any()
    return o, lse


# (head_dim, batch, heads, q_len, kv_len, causal, masked key range, all-masked last sample): 1, 3 and 6 query
# tiles (6: the window's 336 rows), causal and not, key padding, an empty sample; 640 takes two pieces
FWD_CASES = {
    "d384_causal_20_one_tile": (384, 2, 1, 20, 20, True, (0, 3), True),
    "d384_causal_130_three_tiles": (384, 1, 1, 130, 130, True, (0, 7), False),
    "d384_causal_336_six_tiles": (384, 1, 1, 336, 336, True, (256, 276), False),
    "d384_noncausal_130_by_200": (384, 1, 1, 130, 200, False, (150, 170), False),
    "d512_causal_64_one_tile": (512, 1, 2, 64, 64, True, (5, 9), False),
    "d512_noncausal_20_by_77": (512, 2, 1, 20, 77, False, (40, 50), True),
    "d512_causal_129_three_tiles": (512, 1, 1, 129, 129, True, (0, 7), False),
    "d512_causal_336_six_tiles": (512, 1, 1, 336, 336, True, (256, 276), False),
    "d640_causal_33_one_tile": (640, 1, 1, 33, 33, True, (0, 3), False),
    "d640_noncausal_150_by_100": (640, 1, 1, 150, 100, False, (60, 70), False),
    "d640_causal_336_six_tiles": (640, 1, 1, 336, 336, True, (256, 276), False),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_emulated_forward_matches_pallas(case):
    """The forward through the model, with the kernel's split over pieces,
    warpgroups and rounds, against the JAX package's Pallas forward
    (interpret mode) at bf16: o within the card's bf16 tolerance (atol =
    rtol = 2e-2), lse within 1e-4, empty rows with lse +inf and o 0 in
    both."""
    d, b, h, tq, tk, causal, masked, empty = FWD_CASES[case]
    rng = np.random.default_rng(23)
    q = _bf16(rng.normal(size=(b, h, tq, d)))
    k, v = (_bf16(rng.normal(size=(b, h, tk, d))) for _ in range(2))
    mask = np.ones((b, tk), np.int32)
    mask[:, masked[0]:masked[1]] = 0
    if empty:
        mask[-1] = 0
    scale = d ** -0.5
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


def test_the_kernel_is_built_at_its_piece_and_routed_by_pieces():
    """flash_attn_fwd sends every wide head_dim to launch_fwd_wide, which
    launches flash_fwd_wide_kernel<WIDE_FWD_PIECE>; build.py names it
    `flash_fwd_wide_kernel<512>` (WIDE_FWD_PIECE mirrored) beside the
    128-column dK/dV and dQ kernels, whose launchers keep wide_grid."""
    assert "flash_fwd_wide_kernel<WIDE_FWD_PIECE><<<grid, THREADS * wgs, smem, stream>>>(" in LAUNCHER
    assert build.WIDE_FWD_PIECE == CONSTANTS["WIDE_FWD_PIECE"] == 512 and build.WIDE_SLICE == CONSTANTS["WIDE_SLICE"]
    assert build.route("flash_fwd", "bfloat16", 512).instantiation == "flash_fwd_wide_kernel<512>"
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        assert build.route(name, "bfloat16", 512).instantiation == f"{name}_wide_kernel<128>"
        assert f"{name}_wide_kernel<WIDE_SLICE><<<wide_grid(" in FLASH
    assert re.search(r"__launch_bounds__\(PW / WIDE_SLICE \* THREADS, 1\)\s*flash_fwd_wide_kernel\(", FLASH)
