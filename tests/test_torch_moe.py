"""The port's mixture-of-experts layer (`repro_torch.models.moe`) against
the JAX package's ``repro/models/moe.py`` on the same seeded numpy
inputs and weights: y within atol 1e-5 and the load-balancing aux within
1e-6 (fp32), SwiGLU and GELU experts, b in {1, 3} and s in {1, 4, 32};
a capacity factor of 0.5 at s = 32, where tokens are dropped, with the
keep pattern equal to the reference's; ties in the router's
probabilities resolved to the lower expert as ``jax.lax.top_k`` does;
and the MoE layer inside the fused paged step: two host/device
transfers per steady token."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import moe as jax_moe
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCH = "granite-moe-3b-a800m"


def _cfgs(gelu=False, capacity_factor=None):
    over = {"mlp_gelu": gelu}
    if capacity_factor is not None:
        over["moe_capacity_factor"] = capacity_factor
    return (dataclasses.replace(jax_smoke(ARCH), **over),
            dataclasses.replace(smoke_config(ARCH), **over))


def _weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2]))
            .astype(np.float32) for n, s in moe.moe_spec(cfg).items()}


def _both(jcfg, cfg, p, x):
    jy, jaux = jax_moe.moe_apply(
        jcfg, {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    y, aux = moe.moe_apply(cfg, {n: torch.from_numpy(v)
                                 for n, v in p.items()}, torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (y.numpy(), aux.item())


def _jax_keep(jcfg, p, x):
    """The reference's per-(token, slot) keep mask, restated in jnp from
    `repro/models/moe.py`'s routing (top_k, stable argsort, searchsorted
    side="left", position against capacity)."""
    b, s, _ = x.shape
    e, k = jcfg.num_experts, jcfg.top_k
    cap = jax_moe.expert_capacity(jcfg, s)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, topi = jax.lax.top_k(probs, k)

    def row(ti):
        flat_e = ti.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        starts = jnp.searchsorted(e_sorted, jnp.arange(e), side="left")
        pos = jnp.arange(s * k) - starts[e_sorted]
        inv = jnp.zeros((s * k,), jnp.int32).at[order].set(
            jnp.arange(s * k, dtype=jnp.int32))
        return (pos < cap)[inv].reshape(s, k)

    return np.asarray(jax.vmap(row)(topi))


@pytest.mark.parametrize("gelu", [False, True], ids=["swiglu", "gelu"])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 1), (1, 4), (3, 4), (1, 32),
                                 (3, 32)])
def test_moe_apply_matches_jax(gelu, b, s):
    jcfg, cfg = _cfgs(gelu)
    p = _weights(cfg)
    x = np.random.default_rng(b * 100 + s).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    (jy, jaux), (y, aux) = _both(jcfg, cfg, p, x)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=0)
    assert abs(aux - jaux) <= 1e-6
    assert y.dtype == np.float32 and y.shape == x.shape


@pytest.mark.parametrize("gelu", [False, True], ids=["swiglu", "gelu"])
def test_dropping_tokens_matches_jax(gelu):
    """Capacity factor 0.5 at s = 32: capacity 8 against 16 pairs an
    expert on average, so pairs are dropped; the keep pattern, y and aux
    equal the reference's."""
    jcfg, cfg = _cfgs(gelu, capacity_factor=0.5)
    assert moe.expert_capacity(cfg, 32) == 8
    p = _weights(cfg, seed=1)
    x = np.random.default_rng(7).normal(
        size=(3, 32, cfg.d_model)).astype(np.float32)
    (jy, jaux), (y, aux) = _both(jcfg, cfg, p, x)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=0)
    assert abs(aux - jaux) <= 1e-6
    _, _, topi = moe.route(cfg, torch.from_numpy(p["router"]),
                           torch.from_numpy(x))
    *_, pos_tok = moe.dispatch(cfg, topi, 8)
    keep = (pos_tok < 8).numpy()
    want = _jax_keep(jcfg, p, x)
    np.testing.assert_array_equal(keep, want)
    assert 0 < (~keep).sum() < keep.size


def test_dropped_pairs_leave_bucket_zero_intact():
    """Every dropped pair adds zeros into its row's bucket (expert 0,
    slot 0), as the reference's ``.at[...].add`` does: an assigning
    scatter would overwrite that bucket's real token. All tokens go to
    expert 0, so pairs past the capacity are dropped onto a live
    bucket."""
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    p = _weights(cfg, seed=2)
    p["router"][:] = 0.0
    p["router"][:, 0] = 1.0
    p["router"][:, 1] = 0.5
    x = np.abs(np.random.default_rng(3).normal(
        size=(2, 32, cfg.d_model))).astype(np.float32)
    (jy, _), (y, _) = _both(jcfg, cfg, p, x)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=0)
    assert np.abs(y[:, 0]).max() > 0      # token 0 kept in bucket (0, 0)


def test_top_k_ties_take_the_lower_expert():
    """Equal router probabilities: ``jax.lax.top_k`` returns the lower
    expert index first; so does the port's stable sort."""
    jcfg, cfg = _cfgs()
    p = _weights(cfg, seed=4)
    p["router"][:] = 0.0                      # every expert ties
    x = np.random.default_rng(5).normal(
        size=(2, 4, cfg.d_model)).astype(np.float32)
    _, _, topi = moe.route(cfg, torch.from_numpy(p["router"]),
                           torch.from_numpy(x))
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, want = jax.lax.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want))
    assert (topi.numpy() == np.arange(cfg.top_k)).all()
    (jy, jaux), (y, aux) = _both(jcfg, cfg, p, x)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=0)
    assert abs(aux - jaux) <= 1e-6


def test_expert_capacity_matches_jax():
    for arch in ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b"):
        for over in ({}, {"moe_capacity_factor": 0.5}):
            from repro.configs import get_config as jax_get
            from repro_torch.configs import get_config
            for s in (1, 4, 32, 128, 600, 3000):
                assert moe.expert_capacity(get_config(arch, **over), s) == \
                    jax_moe.expert_capacity(jax_get(arch, **over), s)


def test_moe_fused_step_keeps_two_transfers_per_token():
    """The MoE layer inside the fused paged step: `serve` gives the
    reference's tokens and transfer counts, every steady step of it
    crossed host and device twice (one control upload, one token
    download), and three steady steps driven by hand add exactly three
    uploads and three downloads and no device-pool write — routing syncs
    nothing."""
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    jparams = JaxEngine(jax_smoke(ARCH)).params
    state = params_from_numpy(smoke_config(ARCH),
                              jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 6, 11)]
    jeng = JaxEngine(jax_smoke(ARCH), params=jparams,
                     kv_pool=JaxPool(page_tokens=4))
    eng = ServeEngine(smoke_config(ARCH), params=state, device="cpu",
                      kv_pool=PagedKVPool(page_tokens=4))
    kw = dict(max_active=2, chunked_prefill=False, radix=False)
    want = jeng.serve([JaxRequest(p, 8) for p in prompts], preempt=False,
                      **kw)
    got = eng.serve([Request(p, 8) for p in prompts], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.last_transfers == jeng.last_transfers
    assert eng.last_steady_transfers
    assert set(eng.last_steady_transfers) == {(1, 1)}

    cfg = smoke_config(ARCH)
    eng = ServeEngine(cfg, params=state, device="cpu",
                      kv_pool=PagedKVPool(page_tokens=16))
    st = PagedKVState(eng.kv_pool, 32, eng.layout, cfg.num_kv_heads,
                      cfg.head_dim, device="cpu")
    logits, caches = eng.model.forward_prefill(
        torch.from_numpy(prompts[2][None]))
    extract_prefill_pages(eng.model, caches, st, [0])
    step = build_fused_step(eng.model, st.slots)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _, tok = st.run_fused(step, tok, [0], 11)     # syncs the prefill pages
    writes0 = st._device.writes
    h0, d0 = st.transfer_counts()
    for i in range(3):                 # tail rows 12..14 of 16: no fill
        _, tok = st.run_fused(step, tok, [0], 12 + i)
    h1, d1 = st.transfer_counts()
    assert st._device.writes == writes0
    assert (h1 - h0, d1 - d0) == (3, 3)
    st.free_seq(0)
