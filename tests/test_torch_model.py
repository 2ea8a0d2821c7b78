"""The port's `Model` against the JAX `Model` with the same weights: the
JAX ``Model.init`` params carried over through numpy
(`repro_torch.convert.params_from_numpy`), with every zero-initialised
leaf (norm scales, q/k/v biases) overwritten on both sides by the same
seeded noise so that a wrong ``1 + scale`` or a dropped bias shows.
Prefill and dense-cache decode logits agree at atol 1e-4 (fp32, sums
reordered) and a greedy continuation is token-identical. `param_count`
equals the reference's for the ten configs, full and smoke."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.serve.kvcache import pad_caches as jax_pad_caches
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import flatten, unflatten
from repro_torch.models.transformer import Model, pad_caches

ARCHS = ["starcoder2-7b", "llama3-405b"]
ZERO_INIT = ("norm1", "norm2", "final_norm", "bq", "bk", "bv")
ATOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax model, jax params, port model) sharing weights."""
    arch = request.param
    jcfg = jax_smoke(arch)
    jm = JaxModel(jcfg)
    flat = flatten(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(1)
    for name, leaf in flat.items():
        if name.split(".")[-1] in ZERO_INIT:
            assert not leaf.any(), name
            flat[name] = (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
    tree = unflatten(flat)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = Model(smoke_config(arch), device="cpu",
                  state=params_from_numpy(smoke_config(arch), tree))
    return jcfg, jm, jparams, model


def _tokens(cfg, b=2, s=11, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_params_carry_over_leaf_for_leaf(pair):
    jcfg, jm, jparams, model = pair
    jflat = flatten(jax.tree.map(np.asarray, jparams))
    state = dict(model.weights.named_parameters())
    assert set(state) == set(jflat)
    for name, leaf in jflat.items():
        np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert sum(p.numel() for p in model.parameters()) == jm.param_count()


def test_convert_layout_and_errors():
    cfg = smoke_config("starcoder2-7b")
    jm = JaxModel(jax_smoke("starcoder2-7b"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = params_from_numpy(cfg, tree)
    assert len(state) == 14
    assert tuple(state["groups.l0.attn.bk"].shape) == (2, 4, 16)
    flat = flatten(tree)
    bad = dict(flat, **{"groups.l0.attn.bk": np.zeros((2, 4, 8), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, unflatten(bad))
    with pytest.raises(ValueError, match="unexpected"):
        params_from_numpy(cfg, unflatten(dict(flat, extra=np.zeros(3))))


def test_prefill_logits_match(pair):
    jcfg, jm, jparams, model = pair
    toks = _tokens(jcfg)
    want, _ = jax.jit(jm.forward_prefill)(jparams,
                                          {"tokens": jnp.asarray(toks)})
    got, caches = model.forward_prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert len(caches) == jcfg.num_layers
    assert tuple(caches[0]["k"].shape) == (2, 11, jcfg.num_kv_heads,
                                           jcfg.head_dim)


def test_dense_decode_logits_and_greedy_tokens_match(pair):
    jcfg, jm, jparams, model = pair
    toks = _tokens(jcfg, seed=3)
    b, plen = toks.shape
    new, cap = 6, toks.shape[1] + 6
    jl, jc = jax.jit(jm.forward_prefill)(jparams, {"tokens": jnp.asarray(toks)})
    jc = jax_pad_caches(jm, jc, cap, plen)
    tl, tc = model.forward_prefill(torch.from_numpy(toks))
    tc = pad_caches(tc, cap)
    jdec = jax.jit(jm.forward_decode)
    jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    jout, tout = [np.asarray(jtok)], [ttok.numpy()]
    for step in range(new - 1):
        pos = plen + step
        jl, jc = jdec(jparams, {"tokens": jtok[:, None].astype(jnp.int32)},
                      jc, jnp.int32(pos))
        tl = model.forward_decode(ttok[:, None], tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
        jout.append(np.asarray(jtok))
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout), np.stack(jout))


def test_random_init_is_seeded_and_reference_shaped():
    cfg = smoke_config("starcoder2-7b")
    a = Model(cfg, device="cpu", seed=5)
    b = Model(cfg, device="cpu", seed=5)
    c = Model(cfg, device="cpu", seed=6)
    sa, sb, sc = (dict(m.weights.named_parameters()) for m in (a, b, c))
    for name in sa:
        assert torch.equal(sa[name], sb[name])
    assert not torch.equal(sa["embed.tok"], sc["embed.tok"])
    # fan_in init counts every leading dim (layer stack included), as the
    # reference does; norm scales and biases start at zero
    wq = sa["groups.l0.attn.wq"]
    assert abs(wq.std().item() - (2 * 64 * 4) ** -0.5) < 0.01
    assert not sa["groups.l0.norm1"].any() and not sa["groups.l0.attn.bq"].any()
    assert sa["groups.l0.norm1"].dtype == torch.float32


def test_unported_layers_raise():
    """MLA and MoE layers, refused before this port slice, now build: the
    model over a pattern of each holds exactly its spec's leaves, shape
    for shape, and nothing raises."""
    from repro_torch.configs.base import ATTN, MLA, MLP_DENSE, MLP_MOE
    from repro_torch.models.transformer import model_spec
    import dataclasses
    base = smoke_config("starcoder2-7b")
    for pattern, extra in ((((MLA, MLP_DENSE),), dict(
            q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=8,
            v_head_dim=16)), (((ATTN, MLP_MOE),), dict(
                num_experts=4, top_k=2))):
        cfg = dataclasses.replace(base, pattern=pattern, **extra)
        state = dict(Model(cfg, device="cpu").weights.named_parameters())
        spec = flatten(model_spec(cfg))
        assert set(state) == set(spec)
        for name, ps in spec.items():
            assert tuple(state[name].shape) == tuple(ps.shape), name
        leaf = "mla" if pattern[0][0] == MLA else "moe"
        assert any(f".{leaf}." in n for n in state)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", [
    "codeqwen1.5-7b", "granite-moe-3b-a800m", "llama-3.2-vision-11b",
    "llama3-405b", "mamba2-780m", "minicpm3-4b", "musicgen-medium",
    "qwen3-moe-30b-a3b", "recurrentgemma-2b", "starcoder2-7b"])
def test_param_count_equals_reference(arch, size):
    """`Model.param_count()` is the reference's for every config, at its
    published widths (counted on ``meta``) and at smoke size."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config, list_archs
    assert arch in list_archs()
    if size == "full":
        jcfg, cfg, device = jax_get_config(arch), get_config(arch), "meta"
    else:
        jcfg, cfg, device = jax_smoke(arch), smoke_config(arch), "cpu"
    assert Model(cfg, device=device).param_count() == \
        JaxModel(jcfg).param_count()
