"""The port's multi-head latent attention (`repro_torch.models.attention.
mla_apply`) and cross-attention branch against the JAX package's
``repro/models/attention.py`` on the same seeded numpy weights and
inputs (fp32): MLA prefill (latent expanded into per-head keys, causal
`attention_core` at scale 1/sqrt(nope + rope)) and its ``ckv`` /
``krope`` cache, then absorbed-attention decode steps over the padded
cache, written in place; the cross layer's prefill over image
embeddings (tanh-gated, q/k norms of its own) and its decode over the
``xk`` / ``xv`` cache. minicpm3-4b's and llama-3.2-vision-11b's smoke
widths, and minicpm3-4b's published MLA widths for the shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get
from repro.configs import smoke_config as jax_smoke
from repro.models import attention as jax_attn
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as attn
from repro_torch.models.common import flatten

ATOL = 1e-5


def _weights(spec, seed):
    """Every leaf seeded noise — zero-initialised norms and gates too, so a
    wrong ``1 + scale`` or a missing gate shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in flatten(spec).items():
        fan = ps.shape[0] if len(ps.shape) == 1 else \
            int(np.prod(ps.shape[:-1])) if ps.shape else 1
        scale = 0.5 if not ps.shape else \
            0.1 if ps.init == "zeros" else 1 / np.sqrt(fan)
        out[name] = np.asarray(scale * rng.normal(size=ps.shape),
                               np.float32)
    return out


def _split(p):
    return ({n: jnp.asarray(v) for n, v in p.items()},
            {n: torch.from_numpy(v) for n, v in p.items()})


@pytest.mark.parametrize("b,s", [(1, 7), (2, 12)])
def test_mla_prefill_and_decode_match_jax(b, s):
    arch = "minicpm3-4b"
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    jp, tp = _split(_weights(attn.mla_spec(cfg), seed=b))
    rng = np.random.default_rng(s)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jy, jc = jax_attn.mla_apply(jcfg, jp, jnp.asarray(x), mode="prefill",
                                positions=jnp.asarray(pos))
    y, c = attn.mla_apply(cfg, tp, torch.from_numpy(x), mode="prefill",
                          positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    assert set(c) == {"ckv", "krope"}
    assert tuple(c["ckv"].shape) == (b, s, cfg.kv_lora_rank)
    assert tuple(c["krope"].shape) == (b, s, cfg.qk_rope_dim)
    for n in c:
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL, rtol=0)
    cap = s + 4
    jc = {n: jnp.pad(v, ((0, 0), (0, cap - s), (0, 0))) for n, v in jc.items()}
    tc = {n: torch.cat([v, v.new_zeros(b, cap - s, v.shape[2])], 1)
          for n, v in c.items()}
    for step in range(4):
        xd = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jax_attn.mla_apply(jcfg, jp, jnp.asarray(xd), mode="decode",
                                    positions=jnp.int32(s + step), cache=jc)
        y, out = attn.mla_apply(cfg, tp, torch.from_numpy(xd), mode="decode",
                                positions=s + step, cache=tc)
        assert out is tc                         # written in place
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=0)
        for n in tc:
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       atol=ATOL, rtol=0)


def test_mla_spec_matches_jax_at_published_widths():
    cfg, jcfg = get_config("minicpm3-4b"), jax_get("minicpm3-4b")
    want = {n: tuple(v.shape) for n, v in jax_attn.mla_spec(jcfg).items()}
    assert {n: tuple(v.shape) for n, v in attn.mla_spec(cfg).items()} == want
    assert want["wuq"] == (768, 40, 96) and want["wdkv"] == (2560, 288)


@pytest.mark.parametrize("b", [1, 2])
def test_cross_attention_matches_jax(b):
    arch = "llama-3.2-vision-11b"
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    spec = attn.attn_spec(cfg, cross=True)
    assert spec["gate_attn"].shape == () and \
        spec["gate_attn"].dtype == "float32"
    assert {n: tuple(v.shape) for n, v in spec.items()} == {
        n: tuple(v.shape) for n, v in jax_attn.attn_spec(jcfg, cross=True)
        .items()}
    jp, tp = _split(_weights(spec, seed=3 + b))
    rng = np.random.default_rng(b)
    x = rng.normal(size=(b, 9, cfg.d_model)).astype(np.float32)
    img = rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (b, 9))
    jy, jc = jax_attn.attn_apply(jcfg, jp, jnp.asarray(x), mode="prefill",
                                 positions=jnp.asarray(pos),
                                 cross_embeds=jnp.asarray(img))
    y, c = attn.attn_apply(cfg, tp, torch.from_numpy(x), mode="prefill",
                           positions=torch.from_numpy(pos.copy()),
                           cross_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    assert set(c) == {"xk", "xv"}
    for n in c:
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL, rtol=0)
    xd = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    jy, _ = jax_attn.attn_apply(jcfg, jp, jnp.asarray(xd), mode="decode",
                                positions=jnp.int32(9), cache=jc)
    y, out = attn.attn_apply(cfg, tp, torch.from_numpy(xd), mode="decode",
                             positions=9, cache=c)
    assert out is c
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    # the gate: tanh(0) silences the branch, as in the reference
    tp0 = dict(tp, gate_attn=torch.zeros(()))
    y0, _ = attn.attn_apply(cfg, tp0, torch.from_numpy(xd), mode="decode",
                            positions=9, cache=c)
    assert not y0.any()


def test_cross_layer_without_embeddings_runs_self_attention():
    """As in the reference, a cross layer given no image embeddings is a
    plain causal self-attention layer and emits a ``k`` / ``v`` cache."""
    arch = "llama-3.2-vision-11b"
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    jp, tp = _split(_weights(attn.attn_spec(cfg, cross=True), seed=9))
    x = np.random.default_rng(0).normal(size=(1, 6, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    jy, jc = jax_attn.attn_apply(jcfg, jp, jnp.asarray(x), mode="prefill",
                                 positions=jnp.asarray(pos))
    y, c = attn.attn_apply(cfg, tp, torch.from_numpy(x), mode="prefill",
                           positions=torch.from_numpy(pos))
    assert set(c) == set(jc) == {"k", "v"}
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)


def test_mla_rejects_unknown_mode():
    cfg = smoke_config("minicpm3-4b")
    tp = {n: torch.from_numpy(v)
          for n, v in _weights(attn.mla_spec(cfg), 0).items()}
    with pytest.raises(ValueError, match="mode"):
        attn.mla_apply(cfg, tp, torch.zeros(1, 2, cfg.d_model), mode="sample")
