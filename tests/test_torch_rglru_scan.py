"""The port's RG-LRU scan (`repro_torch.kernels.rglru_scan`): its plain
version against the JAX oracle (`ref.lru_scan`) and the Pallas kernel run
in interpret mode on every case of the JAX spec at the spec's tolerance;
the dispatch contract and the wrapper's argument checks; the RG-LRU
layer's prefill (through the wrapper) against the JAX layer's
associative scan, and its one-token step; and the sliding-window
attention layer's prefill (flash wrapper with the window) and ring-
buffer decode against the JAX layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.rglru_scan import ref as jref
from repro.kernels.rglru_scan import spec as jspec
from repro.kernels.rglru_scan.rglru_scan import rglru_scan_pallas
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models.common import materialize
from repro_torch.configs import smoke_config
from repro_torch.kernels import api, registry
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.rglru_scan import ref
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
from repro_torch.models import attention, rglru

SPEC = registry.get("rglru_scan")
ARCH = "recurrentgemma-2b"


def _inputs(shape, seed=0):
    inp = SPEC.example_inputs(shape=shape, seed=seed)
    return ([torch.from_numpy(inp[n]) for n in SPEC.arg_names],
            [jnp.asarray(inp[n]) for n in SPEC.arg_names])


def test_spec_matches_reference_spec():
    """Same cases, tolerance and bit-identical example inputs as the JAX
    spec (whose tiles the port's kernel does not take)."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases] == \
        [dict(c.shape) for c in js.cases]
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
    tol = SPEC.tol[case.dtype]
    targs, jargs = _inputs(dict(case.shape))
    got = api.run("rglru_scan", *targs).numpy()          # plain on the CPU
    want = np.asarray(jref.lru_scan(*jargs))
    pallas = np.asarray(rglru_scan_pallas(
        *jargs, chunk=jspec.SPEC.cases[i].tile["chunk"], interpret=True))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


def test_run_dispatch_and_plain_call_count():
    targs, _ = _inputs(dict(SPEC.cases[0].shape))
    with pytest.raises(ValueError, match="CUDA"):
        api.run("rglru_scan", *targs, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("rglru_scan", *targs, tile={"chunk": 64})
    launches, plain = rglru_scan.launches, rglru_scan.plain_calls
    out = api.run("rglru_scan", *targs)                  # auto on the CPU
    assert rglru_scan.plain_calls == plain + 1
    assert rglru_scan.launches == launches
    assert torch.equal(out, ref.lru_scan(*targs))
    assert "rglru_scan" in registry.names()


@pytest.fixture(scope="module")
def layers():
    """recurrentgemma-2b's smoke RG-LRU and attention params in both
    frameworks."""
    jcfg = jax_smoke(ARCH)
    out = {}
    for name, spec_fn in (("rglru", jrglru.rglru_spec),
                          ("attn", jattn.attn_spec)):
        jp = materialize(spec_fn(jcfg), jax.random.PRNGKey(7), jnp.float32)
        out[name] = (jp, {k: torch.from_numpy(np.array(v))
                          for k, v in jp.items()})
    return jcfg, smoke_config(ARCH), out


@pytest.mark.parametrize("s_len", [40, 3])
def test_rglru_prefill_and_step_match_jax(layers, s_len):
    """The RG-LRU block's prefill (sequential plain scan, through the
    wrapper) against the JAX block's associative scan, and one decode
    step from the prefill cache: y, h and the conv taps at 1e-5."""
    jcfg, cfg, ps = layers
    jp, tp = ps["rglru"]
    x = np.random.default_rng(s_len).normal(
        size=(2, s_len, cfg.d_model)).astype(np.float32)
    want, wcache = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x),
                                      mode="prefill")
    plain = rglru_scan.plain_calls
    got, cache = rglru.rglru_apply(cfg, tp, torch.from_numpy(x),
                                   mode="prefill")
    assert rglru_scan.plain_calls == plain + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for key in ("h", "conv"):
        assert cache[key].dtype == torch.float32
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(wcache[key]), atol=1e-5,
                                   rtol=0)
    x1 = np.random.default_rng(5).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32)
    want1, wcache1 = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x1),
                                        mode="decode", cache=wcache)
    got1, cache1 = rglru.rglru_apply(cfg, tp, torch.from_numpy(x1),
                                     mode="decode", cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(cache1["h"].numpy(), np.asarray(wcache1["h"]),
                               atol=1e-5, rtol=0)


def test_local_attention_prefill_and_ring_decode_match_jax(layers):
    """A sliding-window layer: prefill through the flash wrapper with the
    window (plain on the CPU) against the JAX layer, then ring-buffer
    decode steps past the window (slot = pos % window)."""
    jcfg, cfg, ps = layers
    jp, tp = ps["attn"]
    w = cfg.window
    s_len = 2 * w                   # ring-aligned: a multiple of the window
    x = np.random.default_rng(1).normal(
        size=(1, s_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(s_len, dtype=np.int32)[None]
    want, wcache = jattn.attn_apply(jcfg, jp, jnp.asarray(x), mode="prefill",
                                    positions=jnp.asarray(pos), window=w)
    plain = flash_attention.plain_calls
    got, cache = attention.attn_apply(
        cfg, tp, torch.from_numpy(x), mode="prefill",
        positions=torch.from_numpy(pos), window=w)
    assert flash_attention.plain_calls == plain + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    jring = {k: v[:, -w:] for k, v in wcache.items()}
    ring = {k: v[:, -w:].clone() for k, v in cache.items()}
    for step in range(w + 3):
        x1 = np.random.default_rng(100 + step).normal(
            size=(1, 1, cfg.d_model)).astype(np.float32)
        want1, jring = jattn.attn_apply(
            jcfg, jp, jnp.asarray(x1), mode="decode",
            positions=jnp.int32(s_len + step), cache=jring, window=w)
        got1, ring = attention.attn_apply(
            cfg, tp, torch.from_numpy(x1), mode="decode",
            positions=s_len + step, cache=ring, window=w)
        np.testing.assert_allclose(got1.numpy(), np.asarray(want1),
                                   atol=1e-5, rtol=0)
