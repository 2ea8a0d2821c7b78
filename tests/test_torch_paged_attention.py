"""The port's plain paged attention (`repro_torch.kernels.paged_attention.ref`)
against the JAX oracle and the Pallas kernel run in interpret mode, on
every case of the JAX spec, with flat and layer-stacked pools, mixed
fast/slow pages and a dead row of length 1 — plus the port's dispatch
contract (`kernels.api.run`), the CUDA wrapper's argument checks, its
routes and split plan, and the arithmetic of the split and wgmma routes
emulated here against the plain version at the limit `chip_smoke.py`
holds the card to (with `chip_smoke.py`'s broken variants failing it)."""
import importlib.util
import math
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.paged_attention import spec as jspec
from repro_torch.kernels import api, registry
from repro_torch.kernels.paged_attention import paged_attention as pa_mod
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    _check, paged_attention)

SPEC = registry.get("paged_attention")
N_JAX = len(jspec.SPEC.cases)      # the port's wide case follows the JAX ones
POOLS = ("k_pages", "v_pages", "k_quant", "v_quant", "k_scale", "v_scale")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, stacked: bool):
    """The case's numpy inputs; a dead row (length 1, zero table) when the
    batch has more than one row; layer-stacked: the case's pools are
    layer 1 of 3."""
    inp = SPEC.example_inputs(shape=dict(case.shape))
    if inp["q"].shape[0] > 1:
        inp["lengths"][-1] = 1
        inp["page_table"][-1] = 0
    layer = None
    if stacked:
        others = [SPEC.example_inputs(shape=dict(case.shape), seed=s)
                  for s in (1, 2)]
        for n in POOLS:
            inp[n] = np.stack([others[0][n], inp[n], others[1][n]])
        layer = 1
    return inp, layer


def _jax_args(inp, dtype):
    def cast(v):
        v = jnp.asarray(v)
        return v if jnp.issubdtype(v.dtype, jnp.integer) else v.astype(dtype)
    return [cast(inp[n]) for n in SPEC.arg_names]


def _torch_args(inp, dtype):
    def cast(v):
        t = torch.from_numpy(v)
        return t if not t.is_floating_point() else t.to(dtype)
    return [cast(inp[n]) for n in SPEC.arg_names]


def test_spec_matches_reference_spec():
    """The JAX spec's cases (then the port's one wide case), tolerances
    and (bit-identical) example inputs, so both sides hold the kernel to
    the same data."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases[:N_JAX]] == \
        [dict(c.shape) for c in js.cases]
    assert [c.dtype for c in SPEC.cases[:N_JAX]] == \
        [c.dtype for c in js.cases]
    assert len(SPEC.cases) == N_JAX + 1
    assert dict(SPEC.tol) == dict(js.tol)
    assert SPEC.arg_names == js.arg_names
    for case in SPEC.cases:
        mine = SPEC.example_inputs(shape=dict(case.shape))
        theirs = js.example_inputs(shape=dict(case.shape))
        for n in SPEC.arg_names:
            np.testing.assert_array_equal(mine[n], theirs[n])


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("i", range(N_JAX))
def test_plain_matches_jax_oracle_and_pallas(i, stacked):
    case = SPEC.cases[i]
    inp, layer = _inputs(case, stacked)
    extra = () if layer is None else (layer,)
    tol = SPEC.tol[case.dtype]
    # reference semantics in fp32 on both sides
    got32 = api.run("paged_attention", *_torch_args(inp, torch.float32),
                    *extra, backend="ref").numpy()
    want32 = np.asarray(japi.run("paged_attention",
                                 *_jax_args(inp, jnp.float32),
                                 *((jnp.int32(layer),) if stacked else ()),
                                 backend="ref"))
    np.testing.assert_allclose(got32, want32, atol=5e-6, rtol=0)
    # the case's dtype: the port's plain version and the interpreted
    # Pallas kernel each within tol of the fp32 oracle
    got = api.run("paged_attention", *_torch_args(inp, TDT[case.dtype]),
                  *extra).float().numpy()
    pallas = np.asarray(japi.run(
        "paged_attention", *_jax_args(inp, JDT[case.dtype]),
        *((jnp.int32(layer),) if stacked else ()), backend="pallas",
        tile=dict(jspec.SPEC.cases[i].tile), interpret=True), np.float32)
    np.testing.assert_allclose(got, want32, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


def test_run_contract_and_plain_call_count():
    inp, _ = _inputs(SPEC.cases[0], stacked=False)
    args = _torch_args(inp, torch.float32)
    with pytest.raises(ValueError, match="backend"):
        api.run("paged_attention", *args, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        api.run("paged_attention", *args, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("paged_attention", *args, backend="ref",
                tile={"pages_per_block": 2})
    with pytest.raises(KeyError, match="no kernel"):
        api.run("nope", *args)
    launches, plain = paged_attention.launches, paged_attention.plain_calls
    out = api.run("paged_attention", *args)           # auto on CPU: plain
    assert paged_attention.plain_calls == plain + 1
    assert paged_attention.launches == launches
    np.testing.assert_array_equal(out.numpy(), ref.paged_attention(*args)
                                  .numpy())
    with pytest.raises(ValueError, match="layer"):
        ref.paged_attention(*args, 0)


@pytest.mark.parametrize("breakage", [
    "pool_dtype", "quant_dtype", "table_dtype", "noncontiguous", "head_dim",
    "stacked_no_layer", "layer_range", "scale_shape"])
def test_cuda_wrapper_checks_raise(breakage):
    """The checks the wrapper runs before a launch (exercised here on CPU
    tensors, which is the same Python code the card path runs)."""
    inp, layer = _inputs(SPEC.cases[0], stacked=breakage in (
        "stacked_no_layer", "layer_range"))
    a = dict(zip(SPEC.arg_names, _torch_args(inp, torch.float32)))
    if breakage == "pool_dtype":
        a["v_pages"] = a["v_pages"].double()
    elif breakage == "quant_dtype":
        a["k_quant"] = a["k_quant"].int()
    elif breakage == "table_dtype":
        a["page_table"] = a["page_table"].long()
    elif breakage == "noncontiguous":
        a["q"] = a["q"].transpose(0, 1).contiguous().transpose(0, 1)
    elif breakage == "head_dim":
        a["q"] = torch.zeros(a["q"].shape[:-1] + (300,))
    elif breakage == "stacked_no_layer":
        layer = None
    elif breakage == "layer_range":
        layer = 3
    elif breakage == "scale_shape":
        a["k_scale"] = a["k_scale"][..., :1].contiguous()
    with pytest.raises((ValueError, TypeError)):
        _check(*(a[n] for n in SPEC.arg_names), layer)


def test_cuda_wrapper_accepts_valid_arguments():
    for stacked in (False, True):
        inp, layer = _inputs(SPEC.cases[4], stacked)
        _check(*_torch_args(inp, torch.bfloat16), layer)
    assert pa_mod.MAX_HEAD_DIM >= 128


# ---------------------------------------------------------------------------
# The Hopper routes' arithmetic, emulated in plain PyTorch (used by nothing
# but these tests), against the plain version at the limit `chip_smoke.py`
# holds the card to (`ulp_check`: 2 ulps of |want| in the output dtype +
# 1e-6 per element).
# ---------------------------------------------------------------------------
ROOT = Path(__file__).resolve().parents[1]
SMS = 132                        # the H100's SMs, for `split_plan`


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The emulations' products are small (64 x 128 x 64): torch's intra-op
    threads gain nothing on them, and beside other test workers on the
    same cores they cost a hundred times the arithmetic (one seed of
    `test_two_bf16_pieces_are_not_enough`: 129.5 s at the default thread
    count, 1.4 s at one, beside a loaded machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its helpers run on any device)."""
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _gathered(args, layer):
    """Per sequence: the dequantized K and V of every table position (as
    the plain version dequantizes them) and q, in fp32: (b, S, hkv, d)."""
    q, kf, vf, kq, vq, ks, vs, table, lengths = args
    if layer is not None:
        kf, vf, kq, vq, ks, vs = (x[layer] for x in (kf, vf, kq, vq, ks, vs))
    tab = table.long()
    b, span = tab.shape[0], tab.shape[1] * kf.shape[1]
    hkv, d = kf.shape[2], kf.shape[3]
    k = ref.dequantize_pool(kf[tab], kq[tab], ks[tab]).reshape(b, span, hkv, d)
    v = ref.dequantize_pool(vf[tab], vq[tab], vs[tab]).reshape(b, span, hkv, d)
    return k, v


def split_emulation(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
                    page_table, lengths, layer=None, *, sms=SMS,
                    drop_last=False, pages_per_block=0):
    """The split route's arithmetic (`csrc/paged_split.cuh`): the table's
    positions cut by `split_plan` (at ``pages_per_block``) into splits
    of whole tiles; per split
    and row an fp32 online softmax over its tiles (q pre-scaled, scores
    as fp32 dots, masked p = 0, acc = acc * corr + p V), giving (m, l,
    acc); then the combine, O = sum_s exp(m_s - M) acc_s / max(sum_s
    exp(m_s - M) l_s, 1e-30) over the splits with l_s > 0. ``drop_last``
    leaves the last split out of the combine (a broken kernel)."""
    args = (q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
            page_table, lengths)
    k, v = _gathered(args, layer)
    multi = q.ndim == 4
    qq = q if multi else q[:, None]
    b, rows, hq, d = qq.shape
    span, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    tp = pa_mod.split_tile(d)
    splits, chunk = pa_mod.split_plan(
        b, hkv, span, d, sms, page_tokens=k_pages.shape[-3],
        pages_per_block=pages_per_block)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.zeros(b, rows, hq, d)
    for bi in range(b):
        last = min(int(lengths[bi]) + rows - 1, span)
        lim = int(lengths[bi]) + torch.arange(rows).repeat_interleave(g)
        for h in range(hkv):
            qr = qq[bi, :, h * g:(h + 1) * g].reshape(rows * g, d).float() \
                * scale
            parts = []
            for s in range(splits):
                start, end = s * chunk, min((s + 1) * chunk, last)
                m = torch.full((rows * g,), -1e30)
                l = torch.zeros(rows * g)
                acc = torch.zeros(rows * g, d)
                for p0 in range(start, end, tp):
                    p1 = min(p0 + tp, end)
                    x = qr @ k[bi, p0:p1, h].T
                    ok = torch.arange(p0, p1)[None] < lim[:, None]
                    x = torch.where(ok, x, torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.amax(-1))
                    p = torch.where(ok, torch.exp(x - m_new[:, None]),
                                    torch.tensor(0.0))
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p @ v[bi, p0:p1, h]
                    m = m_new
                if end > start:
                    parts.append((m, l, acc))
            if drop_last and len(parts) > 1:
                parts = parts[:-1]
            mx = torch.stack([pt[0] for pt in parts]).amax(0)
            o = torch.zeros(rows * g, d)
            lsum = torch.zeros(rows * g)
            for m, l, acc in parts:
                w = torch.where(l > 0, torch.exp(m - mx), torch.tensor(0.0))
                o = o + w[:, None] * acc
                lsum = lsum + l * w
            o = o / lsum.clamp_min(1e-30)[:, None]
            out[bi, :, h * g:(h + 1) * g] = o.reshape(rows, g, d)
    out = out.to(q.dtype)
    return out if multi else out[:, 0]


def _pieces(x, n):
    """x as n bf16 pieces, each the rounding of what the ones before left."""
    out, rest = [], x.float()
    for _ in range(n):
        piece = rest.to(torch.bfloat16).float()
        out.append(piece)
        rest = rest - piece
    return out


def wgmma_emulation(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
                    page_table, lengths, layer=None, *, k_pieces=3,
                    p_pieces=3, v_pieces=3):
    """The wgmma route's arithmetic (`csrc/paged_attention.cu`): blocks of
    64 rows (one warpgroup) walking tiles of 64 positions (16 at d = 256)
    up to the last position the block's last row sees; S = ks * (Q Kq^T)
    + Q Klo^T + Q Kmid^T + Q Khi^T with K's float tier in `k_pieces` bf16
    pieces and its int8 tier exact, times scale * log2(e) in fp32; online
    softmax in exp2 (masked p = 0); O += sum_{i + j < n} P_i V_j + sum_i
    (P vs)_i Vq with P, P * vs and V's float tier in pieces (cross terms
    of a higher order dropped; n = `p_pieces`, `v_pieces` for the float
    product's i and j); O / max(l, 1e-30) in q's dtype."""
    args = (q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
            page_table, lengths)
    qd, kfl, vfl, kq8, vq8, ksc, vsc = args[:7]
    if layer is not None:
        kfl, vfl, kq8, vq8, ksc, vsc = (x[layer] for x in (
            kfl, vfl, kq8, vq8, ksc, vsc))
    b, rows, hq, d = q.shape
    t, hkv = kfl.shape[1], kfl.shape[2]
    g = hq // hkv
    bn = 64 if d <= 128 else 16
    sl2 = torch.tensor(1.0 / math.sqrt(d) * math.log2(math.e),
                       dtype=torch.float32)
    out = torch.zeros(b, rows, hq, d)
    for bi in range(b):
        length = int(lengths[bi])
        tab = page_table[bi].long()
        for h in range(hkv):
            qr = q[bi, :, h * g:(h + 1) * g].reshape(rows * g, d).float()
            for r0 in range(0, rows * g, 64):
                rr = torch.arange(r0, min(r0 + 64, rows * g))
                lim = length + rr // g
                end = min(int(lim.max()), tab.shape[0] * t)
                pos = torch.arange(end)
                pid, w = tab[pos // t], pos % t
                kf, vf = kfl[pid, w, h].float(), vfl[pid, w, h].float()
                kq, vq = kq8[pid, w, h].float(), vq8[pid, w, h].float()
                ks, vs = ksc[pid, w, h].float(), vsc[pid, w, h].float()
                kp, vp = _pieces(kf, k_pieces), _pieces(vf, v_pieces)
                m = torch.full((len(rr),), -1e30)
                l = torch.zeros(len(rr))
                o = torch.zeros(len(rr), d)
                qb = qr[rr]
                for p0 in range(0, end, bn):
                    sl = slice(p0, min(p0 + bn, end))
                    s = (qb @ kq[sl].T) * ks[sl][None]
                    for piece in reversed(kp):
                        s = s + qb @ piece[sl].T
                    ok = torch.arange(p0, sl.stop)[None] < lim[:, None]
                    x = torch.where(ok, s * sl2, torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.where(ok, torch.exp2(x - m_new[:, None]),
                                    torch.tensor(0.0))
                    l = l * corr + p.sum(-1)
                    o = o * corr[:, None]
                    m = m_new
                    pp = _pieces(p, p_pieces)
                    for i in range(p_pieces):
                        for j in range(v_pieces):
                            if i + j < max(p_pieces, v_pieces):
                                o = o + pp[i] @ vp[j][sl]
                    for piece in _pieces(p * vs[sl][None], p_pieces):
                        o = o + piece @ vq[sl]
                o = o / l.clamp_min(1e-30)[:, None]
                out[bi, rr // g, h * g + rr % g] = o
    return out.to(q.dtype)


def _narrow(shape, lengths, dead=(), seed=0, dtype=torch.float32, rows=1,
            stacked=False):
    """Spec-generator inputs (odd pages slow) at a narrow shape with the
    given lengths; `dead` rows get length 1 and a zero table. q in
    `dtype`, the pools in fp32, as the serve path feeds the kernel."""
    inp = SPEC.example_inputs(shape={**shape, "k": rows}, seed=seed)
    inp["lengths"] = np.asarray(lengths, np.int32)
    for i in dead:
        inp["lengths"][i] = 1
        inp["page_table"][i] = 0
    layer = None
    if stacked:
        other = SPEC.example_inputs(shape={**shape, "k": rows}, seed=seed + 1)
        for n in POOLS:
            inp[n] = np.stack([other[n], inp[n]])
        layer = 1
    args = _torch_args(inp, torch.float32)
    args[0] = args[0].to(dtype)
    return args, layer


# starcoder2-7b's g = 9 at a narrow d: lengths 1, a split edge (32, 33:
# the plan cuts 96 positions into 3 splits of 32), a page + 1 (17) and a
# dead row
NARROW = {"b": 5, "pages": 30, "page_tokens": 16, "slots": 6, "hq": 9,
          "hkv": 1, "d": 32}
NARROW_LENGTHS = [1, 32, 33, 17, 90]


@pytest.mark.parametrize("i", range(len(SPEC.cases)))
def test_split_arithmetic_meets_the_card_limit_on_spec_cases(chip_smoke, i):
    case = SPEC.cases[i]
    for stacked in (False, True):
        inp, layer = _inputs(case, stacked)
        args = _torch_args(inp, TDT[case.dtype])
        extra = () if layer is None else (layer,)
        want = ref.paged_attention(*args, *extra)
        got = split_emulation(*args, layer)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert chip_smoke.ulp_check(got, want)[2] <= 1.0


@pytest.mark.parametrize("rows,dtype", [(1, torch.float32),
                                        (1, torch.bfloat16),
                                        (4, torch.bfloat16)])
def test_split_arithmetic_meets_the_card_limit_at_g9(chip_smoke, rows, dtype):
    assert pa_mod.split_plan(5, 1, 96, 32, SMS) == (3, 32)
    args, layer = _narrow(NARROW, [n - rows + 1 if n > rows else n
                                   for n in NARROW_LENGTHS],
                          dead=(4,), dtype=dtype, rows=rows, stacked=True)
    want = ref.paged_attention(*args, layer)
    got = split_emulation(*args, layer)
    assert chip_smoke.ulp_check(got, want)[2] <= 1.0
    assert chip_smoke.ulp_check(split_emulation(*args, layer, drop_last=True),
                                want)[2] > 1.0


WGMMA_CASES = [
    # g = 9, k = 8 (72 rows: a ragged second block of rows), d = 64, a
    # row of length 1 and a dead row
    ({"b": 4, "pages": 24, "page_tokens": 32, "slots": 6, "hq": 9,
      "hkv": 1, "d": 64}, [1, 150, 65, 40], (3,), 8),
    # d = 128, two kv heads, k = 16 (144 rows)
    ({"b": 2, "pages": 12, "page_tokens": 64, "slots": 4, "hq": 18,
      "hkv": 2, "d": 128}, [100, 200], (), 16),
    # d = 256 (16-position tiles), g = 10, k = 7
    ({"b": 2, "pages": 8, "page_tokens": 16, "slots": 4, "hq": 10,
      "hkv": 1, "d": 256}, [50, 9], (), 7),
]


@pytest.mark.parametrize("shape,lengths,dead,rows", WGMMA_CASES,
                         ids=["g9_d64_ragged_dead", "g9_d128", "g10_d256"])
def test_wgmma_arithmetic_meets_the_card_limit(chip_smoke, shape, lengths,
                                                dead, rows):
    """K, P and V in three bf16 pieces each, the int8 scale on S's and P's
    columns: within the limit; K or P in one piece: far over it."""
    args, layer = _narrow(shape, lengths, dead=dead, dtype=torch.bfloat16,
                          rows=rows, stacked=True)
    want = ref.paged_attention(*args, layer)
    got = wgmma_emulation(*args, layer)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert chip_smoke.ulp_check(got, want)[2] <= 1.0
    assert chip_smoke.ulp_check(wgmma_emulation(*args, layer, k_pieces=1),
                                want)[2] > 10.0
    assert chip_smoke.ulp_check(wgmma_emulation(*args, layer, p_pieces=1),
                                want)[2] > 10.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_bf16_pieces_are_not_enough(chip_smoke, seed):
    """K, P and V in two pieces each (hi + lo, 16 significant bits) miss
    the limit where outputs near 0 are held to about 1e-6, at a chunk-fill
    step's k = 128 rows (1152 rows a kv head) and d = 128; three do
    not."""
    shape = {"b": 3, "pages": 18, "page_tokens": 128, "slots": 6, "hq": 18,
             "hkv": 2, "d": 128}
    args, layer = _narrow(shape, [1, 500, 640], dtype=torch.bfloat16,
                          rows=128, stacked=True, seed=seed)
    want = ref.paged_attention(*args, layer)
    two = wgmma_emulation(*args, layer, k_pieces=2, p_pieces=2, v_pieces=2)
    assert chip_smoke.ulp_check(two, want)[2] > 1.0
    assert chip_smoke.ulp_check(wgmma_emulation(*args, layer),
                                want)[2] <= 1.0


@pytest.mark.parametrize("rows", [1, 16])
def test_chip_smoke_broken_variants_fail_the_limit(chip_smoke, rows):
    """The three broken plain versions `chip_smoke.py` holds against the
    limit on the card fail it here too; unbroken, the same code is the
    plain version."""
    shape = {"b": 3, "pages": 24, "page_tokens": 64, "slots": 8, "hq": 18,
             "hkv": 2, "d": 64}
    args, layer = _narrow(shape, [400, 300, 120], dtype=torch.bfloat16,
                          rows=rows, stacked=True)
    want = ref.paged_attention(*args, layer)
    assert chip_smoke.PAGED_FAULTS == ("k_one_piece", "drop_last_split",
                                       "no_int8_scale")
    with mock.patch.object(pa_mod, "_sm_count", lambda index: SMS):
        torch.testing.assert_close(
            chip_smoke.paged_variant(args, layer, rows, fault=None), want,
            atol=0, rtol=0)
        for fault in chip_smoke.PAGED_FAULTS:
            assert chip_smoke.ulp_check(chip_smoke.paged_variant(
                args, layer, rows, fault=fault), want)[2] > 1.0, fault


def test_chip_smoke_counts_the_wgmma_products(chip_smoke):
    """On a mixed pool (odd pages int8) every 64-position tile of a
    128-row block is one tier: 9 products on a float page, 4 on an int8
    page, each per warpgroup."""
    shape = {"b": 1, "pages": 4, "page_tokens": 64, "slots": 4, "hq": 9,
             "hkv": 1, "d": 64}
    args, layer = _narrow(shape, [129], dtype=torch.bfloat16, rows=16,
                          stacked=True)
    args[7] = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    # 144 rows: blocks of 128 and 16 rows see 129 + 7 and 129 + 15
    # positions: tiles on pages 0 (float), 1 (int8), 2 (float)
    products, flops = chip_smoke.paged_tc_products(args, layer, 16)
    assert products == 2 * 2 * (9 + 4 + 9)
    assert flops == products * 2 * 64 * 64 * 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 64, 65, 1152])
@pytest.mark.parametrize("d", [16, 24, 64, 128, 256])
def test_route_is_chosen_by_dtype_rows_and_head_dim(dtype, rows, d):
    if rows <= 64:
        want = "split" if d in (16, 32, 64, 128, 256) else "simt"
    else:
        want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128, 256) \
            else "simt"
    assert pa_mod.route(dtype, rows, d) == want
    assert pa_mod.ROUTES == ("split", "wgmma", "simt")


@pytest.mark.parametrize("b,hkv,positions,d", [
    (4, 4, 2048, 128), (2, 4, 640, 128), (1, 1, 100, 64), (64, 8, 4096, 128),
    (1, 1, 100000, 256), (3, 2, 17, 16)])
def test_split_plan_covers_the_table_from_static_shapes(b, hkv, positions,
                                                        d):
    splits, chunk = pa_mod.split_plan(b, hkv, positions, d, SMS)
    tp = pa_mod.split_tile(d)
    assert 1 <= splits <= pa_mod.MAX_SPLITS
    assert chunk % tp == 0
    assert (splits - 1) * chunk < positions <= splits * chunk
    if b * hkv < SMS and positions > tp:
        assert splits > 1                 # more blocks than (b, kv head)s


@pytest.mark.parametrize("name", ["k_pages", "v_pages", "k_quant", "v_quant",
                                  "q"])
@pytest.mark.parametrize("rows", [1, 16])
def test_split_and_wgmma_routes_need_16_byte_aligned_tensors(name, rows):
    """The split and wgmma routes copy pool rows (and wgmma q rows) 16
    bytes at a time: a misaligned tensor raises; the simt route (fp32 q
    at many rows) takes it."""
    shape = {"b": 2, "pages": 8, "page_tokens": 16, "slots": 4, "hq": 18,
             "hkv": 2, "d": 64}
    args, _ = _narrow(shape, [20, 30], dtype=torch.bfloat16, rows=rows)
    a = dict(zip(SPEC.arg_names, args))
    kind = pa_mod.route(torch.bfloat16, rows * 9, 64)
    assert kind == ("split" if rows == 1 else "wgmma")
    x = a[name]
    base = torch.zeros(x.numel() + 16, dtype=x.dtype)
    step = 16 // x.element_size() // 2 or 1
    shifted = base[step:step + x.numel()].view(x.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert _check(*args, None) == kind
    bad = dict(a, **{name: shifted})
    if name == "q" and kind == "split":
        assert _check(*(bad[n] for n in SPEC.arg_names), None) == "split"
        return
    with pytest.raises(ValueError, match="16-byte"):
        _check(*(bad[n] for n in SPEC.arg_names), None)
    if rows > 1:                       # fp32 q at 144 rows: simt, no check
        f32 = dict(bad, q=bad["q"].float() if name != "q"
                   else torch.zeros(x.shape + (1,))[..., 0].float())
        assert _check(*(f32[n] for n in SPEC.arg_names), None) == "simt"


# ---------------------------------------------------------------------------
# The split route's tile (`pages_per_block`), its Hopper cost model and knee
# ---------------------------------------------------------------------------
# (grid shape, q dtype): starcoder2-7b decode at b = 4 and at a 2x2 plan's
# shard, the k = 4 verify, a k = 128 chunk fill (the wgmma route, flat in
# the tile), fp32 q, and a spec case
TILE_GRIDS = [((4, 128, 24, 36, 4, 128, 1), "bfloat16"),
              ((1, 128, 2, 18, 2, 128, 1), "bfloat16"),
              ((2, 128, 8, 36, 4, 128, 4), "bfloat16"),
              ((2, 128, 8, 36, 4, 128, 128), "bfloat16"),
              ((4, 128, 24, 36, 4, 128, 1), "float32"),
              ((2, 16, 4, 4, 2, 32, 1), "float32")]


@pytest.mark.parametrize("grid,dtype", TILE_GRIDS)
def test_tile_space_costs_or_refuses_and_knee_is_deterministic(grid, dtype):
    """Every tile either costs (shared bytes, a finite positive time) or
    cannot launch (None); the knee is one launchable tile, the same on
    every search; the launch before tiles (0: the SM-count plan) is in the
    space and launchable; the wgmma route's cost is flat in the tile."""
    from repro_torch.core import autotune
    costs = autotune.space_costs(SPEC, grid, dtype)
    assert len(costs) == len(SPEC.tune_space["pages_per_block"])
    for tile, cost in costs:
        assert cost is None or (cost[0] >= 0 and 0 < cost[1] < math.inf), \
            (tile, cost)
    knee = autotune.autotune_kernel(SPEC, grid, dtype)["knee"]
    assert knee == autotune.autotune_kernel(SPEC, grid, dtype)["knee"]
    by_ppb = {t["pages_per_block"]: c for t, c in costs}
    assert knee.params["pages_per_block"] in by_ppb and \
        by_ppb[knee.params["pages_per_block"]] is not None
    assert 0 in pa_mod.TILE_SPACE["pages_per_block"] and by_ppb[0]
    if grid[-1] * grid[3] // grid[4] > pa_mod.SPLIT_MAX_ROWS:
        assert len({c for c in by_ppb.values()}) == 1


def test_run_takes_the_tile_and_work_ignores_it():
    """`api.run` takes ``pages_per_block`` (the plain version on CPU
    tensors ignores it), refuses unknown names and a tile with ``ref``;
    the cost counter's record (the spec's `work`) is the same at every
    tile."""
    from repro_torch.core import hlo_cost
    inp, _ = _inputs(SPEC.cases[0], stacked=False)
    args = _torch_args(inp, torch.float32)
    want = ref.paged_attention(*args)
    counts = []
    for ppb in pa_mod.TILE_SPACE["pages_per_block"]:
        tile = {"pages_per_block": ppb}
        assert torch.equal(api.run("paged_attention", *args, tile=tile),
                           want)
        counts.append(hlo_cost.analyze(
            lambda *a, t=tile: api.run("paged_attention", *a, tile=t),
            *args))
    assert all(c == counts[0] for c in counts)
    assert counts[0]["kernels"]
    with pytest.raises(ValueError, match="unknown tile"):
        api.run("paged_attention", *args, tile={"head_block": 1})
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run("paged_attention", *args, backend="ref",
                tile={"pages_per_block": 1})


@pytest.mark.parametrize("rows", [1, 4])
def test_split_arithmetic_at_every_tile(chip_smoke, rows):
    """At every ``pages_per_block`` of the space the split route's
    arithmetic (`split_emulation`) stays within the card's 2-ulp limit
    and, where a live row's positions cross into a second split, leaving
    the last split out goes over it; a tile that does not cut
    the positions into whole tiles in at most 64 splits raises, as the
    wrapper does before any launch."""
    args, layer = _narrow(NARROW, [n - rows + 1 if n > rows else n
                                   for n in NARROW_LENGTHS],
                          dead=(4,), dtype=torch.bfloat16, rows=rows,
                          stacked=True)
    want = ref.paged_attention(*args, layer)
    span = NARROW["slots"] * NARROW["page_tokens"]
    checked = 0
    for ppb in pa_mod.TILE_SPACE["pages_per_block"]:
        try:
            splits, chunk = pa_mod.split_plan(
                5, 1, span, 32, SMS, page_tokens=NARROW["page_tokens"],
                pages_per_block=ppb)
        except ValueError:
            assert ppb * NARROW["page_tokens"] % 32
            continue
        got = split_emulation(*args, layer, pages_per_block=ppb)
        assert chip_smoke.ulp_check(got, want)[2] <= 1.0, ppb
        last = int(args[8].max()) + rows - 1     # the longest row's view
        if splits > 1 and last > chunk:
            broken = split_emulation(*args, layer, drop_last=True,
                                     pages_per_block=ppb)
            assert chip_smoke.ulp_check(broken, want)[2] > 1.0, ppb
            checked += 1
    assert checked >= 1


def test_split_plan_by_pages():
    """Whole pages a split, the split count covering the table; a
    non-whole tile or too many splits raise."""
    assert pa_mod.split_plan(2, 4, 1024, 128, SMS, page_tokens=128,
                             pages_per_block=2) == (4, 256)
    assert pa_mod.split_plan(2, 4, 1024, 128, SMS, page_tokens=128,
                             pages_per_block=32) == (1, 4096)
    with pytest.raises(ValueError, match="whole number"):
        pa_mod.split_plan(2, 4, 1024, 128, SMS, page_tokens=16,
                          pages_per_block=1)
    with pytest.raises(ValueError, match="whole number"):
        pa_mod.split_plan(2, 4, 65 * 32, 128, SMS, page_tokens=32,
                          pages_per_block=1)


def test_knee_key_leaves_out_the_pool_page_count(monkeypatch):
    """The grid a knee is keyed on (`_grid_of`) leaves out the pool's
    page count, which no route's cost reads: pools of 16 and of 64 pages
    under one table resolve one knee, and the second resolves nothing."""
    case = SPEC.cases[0]
    small = _torch_args(_inputs(case, stacked=False)[0], torch.float32)
    big = list(small)
    for i in range(1, 7):                        # the six pool tensors
        pad = torch.zeros((48,) + tuple(small[i].shape[1:]),
                          dtype=small[i].dtype)
        big[i] = torch.cat([small[i], pad])
    assert SPEC.grid_of(*small) == SPEC.grid_of(*big)
    assert len(SPEC.grid_of(*small)) == len(SPEC.shape_keys)
    api.invalidate_caches()
    try:
        knee = api.resolve_tile("paged_attention", small)
        assert api.knees_dirty()
        monkeypatch.setattr(api, "_knees_dirty", False)
        assert api.resolve_tile("paged_attention", big) == knee
        assert not api.knees_dirty()
    finally:
        api.invalidate_caches()
