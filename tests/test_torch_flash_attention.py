"""The port's plain flash attention (`repro_torch.kernels.flash_attention.ref`)
against the JAX oracle (`ref.attention`) and the Pallas kernel run in
interpret mode, on every case of the JAX spec at the spec's tolerance,
plus a g = 9 (starcoder2-7b's grouping) and a ragged-length case against
the oracle; the dispatch contract, the routes and the CUDA wrapper's
argument checks; the Hopper (wgmma) kernel's arithmetic, emulated here,
against the plain version at the limit `chip_smoke.py` holds the card to,
with P in three bf16 pieces passing it and P in one or two pieces
failing it, and `chip_smoke.py`'s broken variants failing it too;
`chip_smoke.flash_online_loop` (the simt route's tile order) against the
plain version; and the port's prefill, which now attends through the
flash wrapper, against the JAX prefill."""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention import spec as jspec
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.models import Model as JaxModel
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api, registry
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    WGMMA_HEAD_DIMS, _check, flash_attention, route)
from repro_torch.models.transformer import Model

SPEC = registry.get("flash_attention")
ROOT = Path(__file__).resolve().parents[1]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its helpers run on any device)."""
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _args(inp, dtype, lib):
    if lib == "jax":
        return [jnp.asarray(inp[n]).astype(JDT[dtype]) for n in SPEC.arg_names]
    return [torch.from_numpy(inp[n]).to(TDT[dtype]) for n in SPEC.arg_names]


def test_spec_matches_reference_spec():
    """Same cases (shapes, dtypes, keyword arguments), tolerances and
    bit-identical example inputs as the JAX spec."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases] == \
        [dict(c.shape) for c in js.cases]
    assert [c.dtype for c in SPEC.cases] == [c.dtype for c in js.cases]
    assert [dict(c.kwargs) for c in SPEC.cases] == \
        [dict(c.kwargs) for c in js.cases]
    assert dict(SPEC.tol) == dict(js.tol)
    assert SPEC.arg_names == js.arg_names
    for case in SPEC.cases:
        mine = SPEC.example_inputs(shape=dict(case.shape))
        theirs = js.example_inputs(shape=dict(case.shape))
        for n in SPEC.arg_names:
            np.testing.assert_array_equal(mine[n], theirs[n])


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_plain_matches_jax_oracle_and_pallas(i):
    case = SPEC.cases[i]
    kw = dict(case.kwargs)
    inp = SPEC.example_inputs(shape=dict(case.shape))
    tol = SPEC.tol[case.dtype]
    # the oracle's semantics in fp32 on both sides
    got32 = api.run("flash_attention", *_args(inp, "float32", "torch"),
                    backend="ref", **kw).numpy()
    want32 = np.asarray(jref.attention(*_args(inp, "float32", "jax"), **kw))
    np.testing.assert_allclose(got32, want32, atol=5e-6, rtol=0)
    # the case's dtype: the port's plain version within tol of the JAX
    # oracle and of the interpreted Pallas kernel, both in that dtype
    got = api.run("flash_attention", *_args(inp, case.dtype, "torch"),
                  **kw).float().numpy()
    jargs = _args(inp, case.dtype, "jax")
    oracle = np.asarray(jref.attention(*jargs, **kw), np.float32)
    tile = dict(jspec.SPEC.cases[i].tile)
    pallas = np.asarray(flash_attention_pallas(
        *jargs, block_q=tile["block_q"], block_k=tile["block_k"],
        interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,kw", [
    # starcoder2-7b's grouping: 36 query heads over 4 kv heads
    ({"b": 1, "sq": 40, "skv": 40, "hq": 9, "hkv": 1, "d": 16}, {}),
    # ragged lengths no block size divides (the Pallas kernel cannot take
    # them; the CUDA kernel masks its last tile), windowed
    ({"b": 2, "sq": 37, "skv": 37, "hq": 6, "hkv": 2, "d": 24},
     {"window": 11}),
], ids=["g9", "ragged_window"])
def test_plain_matches_oracle_off_spec(shape, kw):
    inp = SPEC.example_inputs(shape=shape, seed=3)
    got = ref.attention(*_args(inp, "float32", "torch"), **kw).numpy()
    want = np.asarray(jref.attention(*_args(inp, "float32", "jax"), **kw))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_run_dispatch_and_plain_call_count():
    inp = SPEC.example_inputs(shape=dict(SPEC.cases[0].shape))
    args = _args(inp, "float32", "torch")
    with pytest.raises(ValueError, match="CUDA"):
        api.run("flash_attention", *args, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("flash_attention", *args, backend="ref",
                tile={"block_q": 64})
    launches, plain = flash_attention.launches, flash_attention.plain_calls
    routes = dict(flash_attention.launches_by_route)
    out = api.run("flash_attention", *args, causal=False)   # auto on CPU
    assert flash_attention.plain_calls == plain + 1
    assert flash_attention.launches == launches
    assert flash_attention.launches_by_route == routes
    np.testing.assert_array_equal(
        out.numpy(), ref.attention(*args, causal=False).numpy())
    assert "flash_attention" in registry.names()


@pytest.mark.parametrize("breakage", [
    "dtype", "mixed_dtype", "noncontiguous", "head_dim", "kv_heads",
    "kv_shape", "window"])
def test_cuda_wrapper_checks_raise(breakage):
    """The checks the wrapper runs before a launch (exercised on CPU
    tensors: the same Python code the card path runs)."""
    inp = SPEC.example_inputs(shape=dict(SPEC.cases[0].shape))
    q, k, v = _args(inp, "float32", "torch")
    window = 0
    if breakage == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif breakage == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif breakage == "noncontiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif breakage == "head_dim":
        q = torch.zeros(q.shape[:-1] + (300,))
        k = torch.zeros(k.shape[:-1] + (300,))
        v = torch.zeros(v.shape[:-1] + (300,))
    elif breakage == "kv_heads":
        q = torch.zeros(q.shape[:2] + (3,) + q.shape[3:])
    elif breakage == "kv_shape":
        v = v[:, :-1].contiguous()
    elif breakage == "window":
        window = -1
    with pytest.raises((ValueError, TypeError)):
        _check(q, k, v, window)
    _check(*_args(inp, "bfloat16", "torch"), 0)     # valid arguments pass


def wgmma_emulation(q, k, v, *, causal=True, window=0, pieces=3,
                    block_q=None, block_k=None):
    """The Hopper kernel's arithmetic (`csrc/flash_attention.cu`, wgmma
    route) in plain PyTorch, used by nothing but these tests: query blocks
    of `block_q` positions; key tiles of `block_k` (by default the launch
    before tiles: 128 and 128 at d <= 128, 64 at d = 256) over
    the range the block's rows can see, from the tile holding its first
    window position; S = Q K^T with fp32 sums, then one fp32 multiply by
    scale * log2(e); masked scores -1e30; online softmax in exp2; P cut
    into `pieces` bf16 pieces (each the rounding of what the ones before
    left), each multiplied by V and added into the fp32 O; O / max(l,
    1e-30) in the input dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    fixed = fa_mod.fixed_tile(d)
    bm = block_q or fixed["block_q"]
    bn = block_k or fixed["block_k"]
    scale_log2 = torch.tensor(1.0 / math.sqrt(d) * math.log2(math.e),
                              dtype=torch.float32)
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    out = torch.empty(b, hq, sq, d)
    for q0 in range(0, sq, bm):
        rows = min(bm, sq - q0)
        qp = torch.arange(q0, q0 + rows)[:, None]
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(skv, q0 + rows) if causal else skv
        m = torch.full((b, hq, rows), -1e30)
        l = torch.zeros(b, hq, rows)
        o = torch.zeros(b, hq, rows, d)
        for k0 in range(k_lo // bn * bn, k_hi, bn):
            kt, vt = kf[:, :, k0:k0 + bn], vf[:, :, k0:k0 + bn]
            kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
            t = (qf[:, :, q0:q0 + rows] @ kt.transpose(-1, -2)) * scale_log2
            ok = torch.ones(rows, kt.shape[2], dtype=torch.bool)
            if causal:
                ok &= kp <= qp
            if window:
                ok &= kp > qp - window
            t = torch.where(ok, t, torch.tensor(-1e30))
            m_new = torch.maximum(m, t.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(t - m_new[..., None])
            l = l * corr + p.sum(-1)
            m = m_new
            o = o * corr[..., None]
            rest = p
            for _ in range(pieces):
                piece = rest.to(torch.bfloat16).float()
                rest = rest - piece
                o = o + piece @ vt
        out[:, :, q0:q0 + rows] = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


EMULATED = [
    # starcoder2-7b's g = 9, causal, sq = 300: a ragged last query block
    ({"b": 2, "sq": 300, "skv": 300, "hq": 9, "hkv": 1, "d": 128}, {}),
    # recurrentgemma-2b's g = 10 at d = 256 (64-key tiles), windowed
    ({"b": 1, "sq": 700, "skv": 700, "hq": 10, "hkv": 1, "d": 256},
     {"window": 200}),
    # ragged sq = 1000, g = 10, causal
    ({"b": 1, "sq": 1000, "skv": 1000, "hq": 10, "hkv": 1, "d": 128}, {}),
    # non-causal at d = 64
    ({"b": 1, "sq": 1000, "skv": 1000, "hq": 4, "hkv": 2, "d": 64},
     {"causal": False}),
    # non-causal with sq != skv, both ragged
    ({"b": 1, "sq": 200, "skv": 333, "hq": 2, "hkv": 2, "d": 64},
     {"causal": False}),
]


def _bf16_inputs(shape, seed=0):
    inp = SPEC.example_inputs(shape=shape, seed=seed)
    return [torch.from_numpy(inp[n]).to(torch.bfloat16)
            for n in SPEC.arg_names]


@pytest.mark.parametrize("shape,kw", EMULATED,
                         ids=["g9_causal", "g10_d256_window",
                              "g10_ragged_1000", "noncausal_d64",
                              "noncausal_sq_ne_skv"])
def test_wgmma_arithmetic_within_the_card_limit(chip_smoke, shape, kw):
    """P in three bf16 pieces (the kernel's form) stays within the limit
    `chip_smoke.py` holds the kernel to, 2 ulps of |want| in bf16 + 1e-6,
    of the plain version on the same bf16 inputs; P rounded to bf16 once
    (the JAX model's `attention_core` form) exceeds it."""
    q, k, v = _bf16_inputs(shape)
    want = ref.attention(q, k, v, **kw)
    got = wgmma_emulation(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert chip_smoke.ulp_check(got, want)[2] <= 1.0
    single = wgmma_emulation(q, k, v, pieces=1, **kw)
    assert chip_smoke.ulp_check(single, want)[2] > 10.0


def test_two_bf16_pieces_are_not_enough(chip_smoke):
    """hi + lo (16 significant bits of P) misses the limit where outputs
    near 0 are held to about 1e-6; hi + mid + lo does not."""
    q, k, v = _bf16_inputs(EMULATED[0][0])
    want = ref.attention(q, k, v)
    assert chip_smoke.ulp_check(wgmma_emulation(q, k, v, pieces=2),
                                want)[2] > 1.0
    assert chip_smoke.ulp_check(wgmma_emulation(q, k, v, pieces=3),
                                want)[2] <= 1.0


@pytest.mark.parametrize("fault", ["bf16_p", "drop_last_tile"])
def test_chip_smoke_broken_variants_fail_the_limit(chip_smoke, fault):
    """The two broken plain versions `chip_smoke.py` holds against the
    limit on the card fail it here too; unbroken, the same code is the
    plain version."""
    shape = {"b": 1, "sq": 300, "skv": 300, "hq": 4, "hkv": 1, "d": 128}
    q, k, v = _bf16_inputs(shape, seed=2)
    want = ref.attention(q, k, v)
    assert fault in chip_smoke.FLASH_FAULTS
    assert chip_smoke.ulp_check(
        chip_smoke.flash_variant(q, k, v, fault=fault), want)[2] > 1.0
    torch.testing.assert_close(
        chip_smoke.flash_variant(q, k, v, fault=None), want, atol=0, rtol=0)


def test_chip_smoke_counts_noncausal_pairs(chip_smoke):
    q = torch.zeros(2, 10, 3, 8)
    k = torch.zeros(2, 12, 1, 8)
    _, causal = chip_smoke.flash_bytes_and_flops(q, k, k)
    _, full = chip_smoke.flash_bytes_and_flops(q, k, k, causal=False)
    assert full == 4 * 2 * 3 * 8 * 10 * 12
    assert causal == 4 * 2 * 3 * 8 * sum(range(1, 11))


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("window", [0, 24])
def test_online_loop_is_the_plain_softmax(chip_smoke, two_pass, window):
    """`chip_smoke.flash_online_loop` (the simt route's tile order in
    plain PyTorch, which phase `mesh` reports beside a launch past its
    limit) computes the plain version's function: fp32, 70 keys over
    three tiles, GQA 4 / 2, within 1e-6 of `ref.attention`, equal to it
    on one tile."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen) for shape in
               ((2, 70, 4, 32), (2, 70, 2, 32), (2, 70, 2, 32)))
    want = ref.attention(q, k, v, causal=True, window=window)
    got = chip_smoke.flash_online_loop(q, k, v, causal=True, window=window,
                                       two_pass=two_pass)
    assert (got - want).abs().max().item() < 1e-6
    one = chip_smoke.flash_online_loop(q[:, :32], k[:, :32], v[:, :32],
                                       two_pass=two_pass)
    assert torch.equal(one, ref.attention(q[:, :32], k[:, :32], v[:, :32]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 200, 256])
def test_route_is_chosen_by_dtype_and_head_dim(dtype, d):
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128, 256) \
        else "simt"
    assert route(dtype, d) == want
    assert WGMMA_HEAD_DIMS == (64, 128, 256)


def test_wgmma_route_needs_16_byte_aligned_tensors():
    """TMA loads need 16-byte aligned bases: the wgmma route's check
    refuses a misaligned tensor; the simt route does not need it."""
    shape = {"b": 1, "sq": 8, "skv": 8, "hq": 2, "hkv": 1, "d": 64}
    q, k, v = _bf16_inputs(shape)
    base = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(q.shape)              # 2 bytes past alignment
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    _check(q, k, v, 0)
    with pytest.raises(ValueError, match="16-byte"):
        _check(shifted, k, v, 0)
    wide = torch.zeros(q.numel() // 2 + 1, dtype=torch.float32)[1:]
    _check(wide.view(1, 8, 2, 32), k.float()[..., :32].contiguous(),
           v.float()[..., :32].contiguous(), 0)         # simt: accepted


@pytest.mark.parametrize("arch", ["starcoder2-7b", "llama3-405b"])
def test_forward_prefill_matches_jax_through_flash(arch):
    """The port's prefill (flash attention, plain version on the CPU)
    against the JAX `forward_prefill` (jnp `attention_core`) at fp32: last
    position logits and the K/V caches, every layer's attention through
    the flash wrapper."""
    jm = JaxModel(jax_smoke(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = Model(smoke_config(arch), device="cpu", state=params_from_numpy(
        smoke_config(arch), jax.tree.map(np.asarray, jparams)))
    toks = np.random.default_rng(0).integers(
        0, smoke_config(arch).vocab_size, (2, 13)).astype(np.int32)
    want, wcaches = jax.jit(jm.forward_prefill)(
        jparams, {"tokens": jnp.asarray(toks)})
    plain = flash_attention.plain_calls
    got, caches = model.forward_prefill(torch.from_numpy(toks))
    assert flash_attention.plain_calls - plain == smoke_config(arch).num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    wk = np.asarray(wcaches["groups"]["l0"]["k"])        # (groups, b, s, ...)
    np.testing.assert_allclose(caches[0]["k"].numpy(), wk[0], atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# The wgmma route's tiles (`block_q`, `block_k`), cost model and knee
# ---------------------------------------------------------------------------
TILE_GRIDS = [((1, 2048, 2048, 36, 4, 128), "bfloat16"),
              ((1, 600, 600, 36, 4, 128), "bfloat16"),
              ((2, 2300, 2300, 10, 1, 256), "bfloat16"),
              ((1, 1000, 1000, 4, 2, 64), "bfloat16"),
              ((1, 2048, 2048, 36, 4, 128), "float32"),
              ((2, 128, 128, 4, 2, 64), "float32")]


@pytest.mark.parametrize("grid,dtype", TILE_GRIDS)
def test_tile_space_costs_or_refuses_and_knee_is_deterministic(grid, dtype):
    """Every (block_q, block_k) costs or is None exactly where csrc
    builds no instance (shared memory over 227 KB: block_k 128 at d =
    256); the knee is launchable and the same on every search; the launch
    before tiles is in the space and launchable; the simt route (fp32) is
    flat in the tile."""
    from repro_torch.core import autotune
    d = grid[-1]
    costs = autotune.space_costs(SPEC, grid, dtype)
    assert len(costs) == 4
    for tile, cost in costs:
        if dtype == "bfloat16":
            assert (cost is None) == (not fa_mod.wgmma_launchable(
                d, tile["block_q"], tile["block_k"])), tile
        assert cost is None or (cost[0] >= 0 and 0 < cost[1] < math.inf)
    knee = autotune.autotune_kernel(SPEC, grid, dtype)["knee"]
    assert knee == autotune.autotune_kernel(SPEC, grid, dtype)["knee"]
    assert knee.params in [t for t, c in costs if c is not None]
    fixed = fa_mod.fixed_tile(d)
    assert fixed in [t for t, c in costs if c is not None]
    if dtype == "float32":
        assert len({c for _, c in costs}) == 1
    # d = 256 with 128-key tiles: Q 64 KB + 2 stages of 64 KB K and V
    assert fa_mod.wgmma_smem_bytes(256, 128, 128) > fa_mod.SMEM_BYTES


def test_run_takes_the_tiles_and_work_ignores_them():
    from repro_torch.core import hlo_cost
    inp = SPEC.example_inputs(shape=dict(SPEC.cases[0].shape))
    args = _args(inp, "float32", "torch")
    want = ref.attention(*args)
    counts = []
    for bq in fa_mod.TILE_SPACE["block_q"]:
        for bk in fa_mod.TILE_SPACE["block_k"]:
            tile = {"block_q": bq, "block_k": bk}
            assert torch.equal(api.run("flash_attention", *args, tile=tile),
                               want)
            counts.append(hlo_cost.analyze(
                lambda *a, t=tile: api.run("flash_attention", *a, tile=t),
                *args))
    assert all(c == counts[0] for c in counts) and counts[0]["kernels"]
    with pytest.raises(ValueError, match="unknown tile"):
        api.run("flash_attention", *args, tile={"chunk": 64})
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run("flash_attention", *args, backend="ref",
                tile={"block_q": 64, "block_k": 64})


@pytest.mark.parametrize("shape,kw", [EMULATED[0], EMULATED[1]],
                         ids=["g9_causal", "g10_d256_window"])
def test_wgmma_arithmetic_at_every_tile(chip_smoke, shape, kw):
    """At every launchable tile the wgmma route's arithmetic stays within
    the card's limit of the plain version, and the two broken forms
    (P in one bf16 piece; the last `block_k` keys dropped) go over it."""
    q, k, v = _bf16_inputs(shape)
    d = shape["d"]
    want = ref.attention(q, k, v, **kw)
    for bq in fa_mod.TILE_SPACE["block_q"]:
        for bk in fa_mod.TILE_SPACE["block_k"]:
            if not fa_mod.wgmma_launchable(d, bq, bk):
                continue
            got = wgmma_emulation(q, k, v, block_q=bq, block_k=bk, **kw)
            assert chip_smoke.ulp_check(got, want)[2] <= 1.0, (bq, bk)
            one = wgmma_emulation(q, k, v, block_q=bq, block_k=bk, pieces=1,
                                  **kw)
            assert chip_smoke.ulp_check(one, want)[2] > 1.0, (bq, bk)
            drop = chip_smoke.flash_variant(q, k, v, fault="drop_last_tile",
                                            block_k=bk, **kw)
            assert chip_smoke.ulp_check(drop, want)[2] > 1.0, (bq, bk)
