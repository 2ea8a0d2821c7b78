"""The remaining model families through the port against the JAX package,
smoke configs with the same weights (the JAX ``Model.init`` params with
every zero-initialised leaf — norm scales, biases, the cross layer's
tanh gates — replaced by the same seeded noise on both sides):

- configs and specs: the ten architectures, every config and smoke
  config field for field, `model_spec` names, shapes and dtypes equal
  ``Model(cfg).abstract_params()`` at published widths;
- codeqwen1.5-7b (dense, q/k/v bias, MHA), granite-moe-3b-a800m and
  qwen3-moe-30b-a3b (MoE), minicpm3-4b (MLA), llama-3.2-vision-11b
  (cross-attention over image embeddings) and musicgen-medium (external
  frame embeddings): prefill and dense-cache decode logits at atol 1e-4;
- the engine: greedy tokens and request stats of the dense-cache
  `generate` (codeqwen, both MoE families, minicpm3), and of the paged
  `generate`, the default `serve()` (chunked prefill + radix) with its
  pool stats and k = 4 speculative `serve()` (codeqwen, both MoE
  families) equal the JAX engine's;
- the refusals: where and what the JAX engine raises."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get
from repro.configs import list_archs as jax_list
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.engine import ServeSession as JaxSession
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.kvcache import pad_caches as jax_pad_caches
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import flatten, unflatten
from repro_torch.models.transformer import Model, model_spec, pad_caches
from repro_torch.serve.engine import Request, ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool

FAMILIES = ("codeqwen1.5-7b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
            "minicpm3-4b", "llama-3.2-vision-11b", "musicgen-medium")
TOKEN_GENERATE = FAMILIES[:4]       # the engine's dense path serves these
PAGED = FAMILIES[:3]                # and the paged path these
ATOL = 1e-4
T = 4                               # page tokens

_PARAMS: dict = {}


def _params(arch):
    """(JAX params, the port's state dict): the same weights, every leaf
    that the init leaves at zero drawn from seeded noise."""
    if arch not in _PARAMS:
        jm = JaxModel(jax_smoke(arch))
        flat = flatten(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
        rng = np.random.default_rng(1)
        for name, leaf in flat.items():
            if not leaf.any():
                scale = 0.5 if name.split(".")[-1].startswith("gate_") \
                    else 0.1
                flat[name] = np.asarray(scale * rng.normal(size=leaf.shape),
                                        leaf.dtype)
        tree = unflatten(flat)
        _PARAMS[arch] = (jax.tree.map(jnp.asarray, tree),
                         params_from_numpy(smoke_config(arch), tree))
    return _PARAMS[arch]


def _prompts(arch, lengths, seed=0):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(arch).vocab_size
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------
def test_list_archs_equals_reference():
    assert list_archs() == jax_list()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("arch", jax_list())
def test_configs_equal_reference_field_for_field(arch):
    for mine, ref in ((get_config(arch), jax_get(arch)),
                      (smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", jax_list())
def test_model_spec_equals_abstract_params(arch):
    """Names, shapes and dtypes at published widths, llama3-405b
    included: the spec is shapes only, nothing is materialised."""
    cfg = get_config(arch)
    want = flatten(jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        JaxModel(jax_get(arch)).abstract_params()))
    got = {n: (tuple(ps.shape), ps.dtype or cfg.param_dtype)
           for n, ps in flatten(model_spec(cfg)).items()}
    assert got == want


# ---------------------------------------------------------------------------
# The model: prefill and dense-cache decode logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_jax(arch):
    """Prefill (b = 2, s = 11) and 5 dense decode steps, logits at
    atol 1e-4, every layer's prefill cache leaf for leaf. llama-vision
    takes seeded image embeddings, musicgen seeded frame embeddings (a
    fresh frame per decode step); the token models feed back their
    greedy tokens."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    jparams, state = _params(arch)
    jm, model = JaxModel(jcfg), Model(cfg, device="cpu", state=state)
    rng = np.random.default_rng(5)
    b, s, new = 2, 11, 5
    jin, kw = {}, {}
    if cfg.external_embed:
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        jin["embeds"], kw["embeds"] = jnp.asarray(x), torch.from_numpy(x)
    else:
        toks = np.stack(_prompts(arch, [s] * b, seed=3))
        jin["tokens"], kw["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    if cfg.n_img_tokens:
        img = rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model)) \
            .astype(np.float32)
        jin["image_embeds"] = jnp.asarray(img)
        kw["image_embeds"] = torch.from_numpy(img)
    want, wc = jax.jit(jm.forward_prefill)(jparams, jin)
    got, caches = model.forward_prefill(**kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    gs = cfg.group_size()
    assert len(caches) == cfg.num_layers
    for layer, c in enumerate(caches):
        ref = wc["groups"][f"l{layer % gs}"]
        assert set(c) == set(ref)
        for key, val in c.items():
            np.testing.assert_allclose(
                val.numpy(), np.asarray(ref[key])[layer // gs], atol=ATOL,
                rtol=0, err_msg=f"layer {layer} {key}")
    jc = jax_pad_caches(jm, wc, s + new, s)
    tc = pad_caches(caches, s + new, cfg)
    jdec = jax.jit(jm.forward_decode)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    for step in range(new):
        if cfg.external_embed:
            x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
            jin, kw = {"embeds": jnp.asarray(x)}, {"embeds":
                                                   torch.from_numpy(x)}
            targs = (None,)
        else:
            jin = {"tokens": jnp.asarray(tok[:, None])}
            targs, kw = (torch.from_numpy(tok[:, None]),), {}
        wl, jc = jdec(jparams, jin, jc, jnp.int32(s + step))
        tl = model.forward_decode(*targs, tc, s + step, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(wl), atol=ATOL,
                                   rtol=0)
        tok = np.asarray(wl).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), tok)


# ---------------------------------------------------------------------------
# The engine: dense-cache generate, paged generate, serve(), speculation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", TOKEN_GENERATE)
def test_dense_generate_matches_jax(arch):
    """No pool: left-padded prompts of two lengths (the pads are routed
    through the MoE layers too, as in the reference), greedy tokens, an
    eos cut, request stats and the decode step count."""
    jparams, state = _params(arch)
    prompts = _prompts(arch, [9, 5])
    eng = ServeEngine(smoke_config(arch), params=state, device="cpu")
    jeng = JaxEngine(jax_smoke(arch), params=jparams)
    eos = int(ServeEngine(smoke_config(arch), params=state, device="cpu")
              .generate([Request(p, 7) for p in prompts])[1][3])
    want = jeng.generate([JaxRequest(prompts[0], 7),
                          JaxRequest(prompts[1], 5, eos_token=eos)])
    got = eng.generate([Request(prompts[0], 7),
                        Request(prompts[1], 5, eos_token=eos)])
    _same(want, got)
    assert len(got[1]) <= 4
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.stats == dict(jeng.stats, prefill_s=eng.stats["prefill_s"],
                             decode_s=eng.stats["decode_s"])
    assert eng.stats["decode_steps"] == 6


def test_dense_generate_sampling_is_seeded():
    _, state = _params("minicpm3-4b")
    eng = ServeEngine(smoke_config("minicpm3-4b"), params=state,
                      device="cpu")
    prompts = _prompts("minicpm3-4b", [6, 6])

    def run(seed):
        return eng.generate([Request(p, 6) for p in prompts], greedy=False,
                            temperature=1.5, seed=seed)

    _same(run(3), run(3))
    assert any((a != b).any() for a, b in zip(run(3), run(4)))


def _paged(arch, speculate=0):
    jparams, state = _params(arch)
    pool, jpool = PagedKVPool(page_tokens=T), JaxPool(page_tokens=T)
    eng = ServeEngine(smoke_config(arch), params=state, kv_pool=pool,
                      device="cpu", speculate=speculate)
    jeng = JaxEngine(jax_smoke(arch), params=jparams, kv_pool=jpool,
                     decode_mode="fused", speculate=speculate)
    return eng, pool, jeng, jpool


def _check(eng, pool, jeng, jpool, got, want):
    _same(want, got)
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.last_transfers == jeng.last_transfers
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert pool.stats == {k: jpool.stats[k] for k in pool.stats}


@pytest.mark.parametrize("speculate", [0, 4], ids=["plain", "spec4"])
@pytest.mark.parametrize("arch", PAGED)
def test_paged_generate_matches_jax(arch, speculate):
    eng, pool, jeng, jpool = _paged(arch, speculate)
    prompts = _prompts(arch, [10, 7], seed=1)
    want = jeng.generate([JaxRequest(p, n) for p, n in zip(prompts, (8, 6))])
    got = eng.generate([Request(p, n) for p, n in zip(prompts, (8, 6))])
    _check(eng, pool, jeng, jpool, got, want)


@pytest.mark.parametrize("speculate", [0, 4], ids=["plain", "spec4"])
@pytest.mark.parametrize("arch", PAGED)
def test_default_serve_matches_jax(arch, speculate):
    """The default `serve()`: prompts sharing a two-page head admitted two
    at a time, chunked prefill through the widened fused steps (the MoE
    capacity of a chunk step is the chunk's), radix adoption; tokens,
    request stats, transfers, prefix hit rate and pool stats."""
    eng, pool, jeng, jpool = _paged(arch, speculate)
    rng = np.random.default_rng(2)
    vocab = smoke_config(arch).vocab_size
    head = rng.integers(0, vocab, 2 * T).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, vocab, n)
                               .astype(np.int32)]) for n in (5, 9, 2)]
    news = [5, 4, 6]
    want = jeng.serve([JaxRequest(p.copy(), n)
                       for p, n in zip(prompts, news)], max_active=2)
    got = eng.serve([Request(p.copy(), n) for p, n in zip(prompts, news)],
                    max_active=2)
    _check(eng, pool, jeng, jpool, got, want)
    assert eng.last_prefix_hit_rate == jeng.last_prefix_hit_rate > 0
    assert pool.live_pages == 0


# ---------------------------------------------------------------------------
# Refusals: where and what the reference raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,exc", [("llama-3.2-vision-11b", ValueError),
                                      ("musicgen-medium", KeyError)])
def test_engine_cannot_serve_embedding_families(arch, exc):
    """The engine feeds tokens only: llama-vision's cross layers get no
    image embeddings and emit self-attention caches where the cross
    cache belongs (`ValueError` at the dense-cache padding), musicgen's
    prefill finds no frame embeddings (`KeyError`)."""
    jparams, state = _params(arch)
    prompts = _prompts(arch, [6, 4])
    with pytest.raises(exc):
        JaxEngine(jax_smoke(arch), params=jparams).generate(
            [JaxRequest(p, 4) for p in prompts])
    with pytest.raises(exc):
        ServeEngine(smoke_config(arch), params=state, device="cpu") \
            .generate([Request(p, 4) for p in prompts])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llama-3.2-vision-11b"])
def test_paged_mla_and_cross_raise(arch):
    jparams, state = _params(arch)
    prompts = _prompts(arch, [6])
    with pytest.raises(NotImplementedError, match="paged"):
        JaxEngine(jax_smoke(arch), params=jparams,
                  kv_pool=JaxPool(page_tokens=T)).generate(
            [JaxRequest(prompts[0], 4)])
    eng = ServeEngine(smoke_config(arch), params=state, device="cpu",
                      kv_pool=PagedKVPool(page_tokens=T))
    with pytest.raises(NotImplementedError, match="paged"):
        eng.generate([Request(prompts[0], 4)])
    with pytest.raises(NotImplementedError, match="paged"):
        eng.serve([Request(prompts[0], 4)])
    with pytest.raises(NotImplementedError, match="paged"):
        ServeSession(eng, capacity=16)


def test_serve_without_a_pool_raises():
    arch = "granite-moe-3b-a800m"
    jparams, state = _params(arch)
    prompt = _prompts(arch, [6])[0]
    jeng = JaxEngine(jax_smoke(arch), params=jparams)
    eng = ServeEngine(smoke_config(arch), params=state, device="cpu")
    for serve in (lambda: jeng.serve([JaxRequest(prompt, 4)]),
                  lambda: eng.serve([Request(prompt, 4)]),
                  lambda: JaxSession(jeng, capacity=16),
                  lambda: ServeSession(eng, capacity=16)):
        with pytest.raises(ValueError, match="kv_pool"):
            serve()
    with pytest.raises(ValueError, match="kv_pool"):
        eng.generate([Request(prompt, 4, speculate=4)])
