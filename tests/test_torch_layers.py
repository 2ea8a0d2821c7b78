"""The port's layer functions against `repro.models.layers` on the same
seeded numpy inputs, fp32, atol 1e-6 — each pins a reference semantic
that differs from the PyTorch default (fp32 RMSNorm scaling by 1 + scale,
split-half RoPE, tanh GELU, -1e30 padded-vocab mask)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import layers as jl
from repro_torch.configs import smoke_config
from repro_torch.models import layers as tl

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm(rng):
    # unit-scale activations and small norm deltas, as in a trained model:
    # the 1e-6 contract is then a few ulp of the outputs
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(scale)).numpy(), want,
                               atol=ATOL, rtol=0)


def test_rms_norm_keeps_bf16_input_dtype(rng):
    x = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    out = tl.rms_norm(x.bfloat16(), torch.zeros(8))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("pos_shape", [(2, 7), (7,)])
def test_apply_rope(rng, pos_shape):
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=pos_shape).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    1_000_000.0))
    got = tl.apply_rope(_t(x), _t(pos), 1_000_000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # small positions keep the angles small: the 1e-6 contract
    pos = rng.integers(0, 8, size=pos_shape).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    np.testing.assert_allclose(tl.apply_rope(_t(x), _t(pos), 1e4).numpy(),
                               want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "llama3-405b"])
def test_mlp(rng, arch):
    """GELU (tanh form) for starcoder2, SwiGLU for llama3."""
    cfg = smoke_config(arch)
    assert cfg.mlp_gelu == jax_smoke(arch).mlp_gelu == (arch == "starcoder2-7b")
    d, f = cfg.d_model, cfg.d_ff
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    if cfg.mlp_gelu:
        del p["gate"]
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    want = np.asarray(jl.mlp_apply(jax_smoke(arch),
                                   {k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x)))
    got = tl.mlp_apply(cfg, {k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 801)
    want = np.asarray(__import__("jax").nn.gelu(jnp.asarray(x.numpy())))
    got = torch.nn.functional.gelu(x, approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    exact = torch.nn.functional.gelu(x).numpy()
    assert np.abs(exact - want).max() > 1e-4     # the default would drift


@pytest.mark.parametrize("vocab", [256, 300])
def test_embed_and_lm_head(rng, vocab):
    """vocab=300 pads to 512: the padded logits must be masked to -1e30
    (the smoke vocab of 256 and the full 49152 never exercise it)."""
    jcfg = dataclasses.replace(jax_smoke("starcoder2-7b"), vocab_size=vocab)
    cfg = dataclasses.replace(smoke_config("starcoder2-7b"), vocab_size=vocab)
    vp, d = cfg.padded_vocab_size, cfg.d_model
    assert vp == jcfg.padded_vocab_size == (256 if vocab == 256 else 512)
    p = {"tok": rng.normal(size=(vp, d)).astype(np.float32),
         "lm_head": rng.normal(size=(d, vp)).astype(np.float32) / 8}
    tokens = rng.integers(0, vocab, size=(2, 5)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    emb = tl.embed_apply(cfg, tp, _t(tokens).long())
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(jl.embed_apply(jcfg, jp, jnp.asarray(tokens))))
    want = np.asarray(jl.lm_head_apply(jcfg, jp, jnp.asarray(emb.numpy())))
    got = tl.lm_head_apply(cfg, tp, emb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    if vp != vocab:
        assert (got[..., vocab:] == -1e30).all()
        assert (got[..., :vocab] > -1e29).all()
