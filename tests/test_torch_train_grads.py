"""Gradients of the port's training path against the JAX package, on the
CPU (the kernel wrappers' forwards run their plain versions here; the
autograd Functions around them are what is tested):

- each kernel's autograd Function — flash attention (causal, window,
  GQA, softmax_scale, non-causal), the SSD scan (y, and y with the final
  state), the RG-LRU scan (its reverse-scan backward) — against autograd
  of its plain PyTorch version and against ``jax.grad`` of the JAX
  oracle (``repro/kernels/*/ref.py``), on the same seeded inputs and
  output weights; the RG-LRU backward without the one-step shift of a
  lands over the limit;
- ``Model.forward_train`` for all ten smoke configs: logits, aux and the
  loss, and every parameter's gradient against
  ``jax.value_and_grad(make_loss_fn(...))`` with the same weights
  (`numpy_params`: drawn with numpy by the reference's init rules, every
  zero-initialised leaf replaced by seeded noise), no gradient None or
  all-zero where JAX's is not; remat gives the same gradients and
  recomputes the kernels' forwards.

Limits (fp32): Function gradients within 2e-5 * max |want| per tensor
(the plain and JAX versions sum in other orders); model logits at atol
1e-4, the loss and aux within 1e-5, each parameter's gradient within
1e-4 * max |g_jax| (the SSD path's chunked sums differ most: 1.2e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.kernels.flash_attention import ref as jflash
from repro.kernels.rglru_scan import ref as jrglru
from repro.kernels.ssd_scan import ref as jssd
from repro.models import Model as JaxModel
from repro.train.train_step import make_loss_fn as jax_loss_fn
from repro_torch.configs import list_archs, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rglru_scan import ref as rglru_ref
from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
from repro_torch.models.common import flatten, unflatten
from repro_torch.models.transformer import Model, model_spec
from repro_torch.train.train_step import make_loss_fn

FN_LIMIT = 2e-5
GRAD_LIMIT = 1e-4
ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-sized ops gain nothing from torch's intra-op thread pool, and
    beside other test workers on the same cores its spinning threads cost
    several times what they save (a 60-step CPU run: 2 s alone, 38 s
    under three workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, limit=FN_LIMIT):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= limit * scale, (err, scale)
    return err / scale


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _torch_grads(fn, arrays, weights):
    leaves = _leaves(arrays)
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(w)).sum()
               for o, w in zip(outs, weights) if w is not None)
    return outs, torch.autograd.grad(loss, leaves, allow_unused=True)


def _jax_grads(fn, arrays, weights):
    def loss(*xs):
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o * w).sum() for o, w in zip(outs, weights)
                   if w is not None)
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])


# ---------------------------------------------------------------------------
# the Functions
# ---------------------------------------------------------------------------
FLASH_CASES = {
    "causal_gqa": dict(sq=24, hq=4, hkv=2, causal=True, window=0),
    "window": dict(sq=40, hq=4, hkv=1, causal=True, window=9),
    "scale": dict(sq=17, hq=2, hkv=2, causal=True, window=0,
                  softmax_scale=0.3),
    "noncausal_mqa": dict(sq=12, hq=6, hkv=1, causal=False, window=0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward(case):
    kw = dict(FLASH_CASES[case])
    sq, hq, hkv = kw.pop("sq"), kw.pop("hq"), kw.pop("hkv")
    rng = np.random.default_rng(7)
    d = 16
    q = rng.standard_normal((2, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((2, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, sq, hkv, d)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    (out,), got = _torch_grads(
        lambda *x: fa_mod.flash_attention(*x, **kw), (q, k, v), (w,))
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    _, plain = _torch_grads(lambda *x: flash_ref.attention(*x, **kw),
                            (q, k, v), (w,))
    want = _jax_grads(lambda *x: jflash.attention(*x, **kw), (q, k, v), (w,))
    for g, p, j in zip(got, plain, want):
        _close(g, p)
        _close(g, j)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_backward(with_state):
    rng = np.random.default_rng(3)
    B, S, H, P, G, N = 2, 40, 4, 8, 2, 6
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if with_state else None
    arrays = (x, bm, cm, dt, a)
    (y, _), got = _torch_grads(ssd_mod.ssd_scan, arrays, (wy, ws))
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    _, plain = _torch_grads(ssd_ref.ssd_chunked, arrays, (wy, ws))
    want = _jax_grads(jssd.ssd, arrays, (wy, ws))
    for g, p, j in zip(got, plain, want):
        _close(g, p)
        _close(g, j)


def test_rglru_backward_is_the_reverse_scan():
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 0.99, (2, 45, 12)).astype(np.float32)
    b = rng.standard_normal((2, 45, 12)).astype(np.float32)
    w = rng.standard_normal((2, 45, 12)).astype(np.float32)
    calls = rg_mod.rglru_scan.plain_calls
    (h,), got = _torch_grads(rg_mod.rglru_scan, (a, b), (w,))
    # one forward and one reverse scan, both through the wrapper
    assert rg_mod.rglru_scan.plain_calls - calls == 2
    assert type(h.grad_fn).__name__ == "RglruScanFnBackward"
    _, plain = _torch_grads(rglru_ref.lru_scan, (a, b), (w,))
    want = _jax_grads(jrglru.lru_scan, (a, b), (w,))
    for g, p, j in zip(got, plain, want):
        _close(g, p)
        _close(g, j)
    # the same reverse scan without the one-step shift of a
    ta, th = torch.from_numpy(a), h.detach()
    lam = rg_mod.rglru_scan(ta.flip(1).contiguous(),
                            torch.from_numpy(w).flip(1).contiguous()).flip(1)
    with pytest.raises(AssertionError):
        _close(lam, plain[1])
    da, db = rg_mod.lru_vjp(ta, th, torch.from_numpy(w))
    _close(db, plain[1])
    _close(da, plain[0])


def test_dispatch_reaches_the_functions():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 8, 1, 16)).astype(
        np.float32))
    out = api.run("flash_attention", q, k, k, backend="auto")
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out = api.run("flash_attention", q, k, k, backend="ref")
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    with torch.no_grad():
        assert api.run("flash_attention", q, k, k).grad_fn is None
    a = torch.rand(1, 5, 3, requires_grad=True)
    assert type(api.run("rglru_scan", a, a).grad_fn).__name__ == \
        "RglruScanFnBackward"


# ---------------------------------------------------------------------------
# forward_train against JAX, all ten smoke configs
# ---------------------------------------------------------------------------
def numpy_params(cfg, seed: int) -> dict:
    """Weights for `cfg` as a nested numpy tree, drawn with numpy by the
    reference's init rules (``repro/models/common.py``: ones, fan_in,
    normal, alog, lambda), every zero-initialised leaf replaced by 0.1 *
    normal noise so that its gradient and the ones behind it are live.
    Both packages start from it; JAX's own ``Model.init`` draws leaf by
    leaf and costs seconds a config on the CPU."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, ps in flatten(model_spec(cfg)).items():
        shape = tuple(ps.shape)
        if ps.init == "ones":
            leaf = np.ones(shape)
        elif ps.init in ("alog", "lambda"):
            lo, hi = (1.0, 16.0) if ps.init == "alog" else (0.9, 0.999)
            u = rng.uniform(lo, hi, shape)
            leaf = np.log(u) if ps.init == "alog" else np.log(u / (1 - u))
        else:
            fan_in = shape[0] if len(shape) == 1 else int(np.prod(shape[:-1]))
            std = {"zeros": 0.1, "normal": ps.scale,
                   "fan_in": 1.0 / np.sqrt(max(fan_in, 1))}[ps.init]
            leaf = std * rng.standard_normal(shape)
        flat[name] = leaf.astype(ps.dtype or cfg.param_dtype)
    return unflatten(flat)


def _shared(arch, seq=40, batch=2):
    """(jax model, jax params, port model, numpy batch) with the same
    `numpy_params` weights."""
    cfg = smoke_config(arch)
    tree = numpy_params(cfg, 1)
    jm = JaxModel(jax_smoke(arch))
    model = Model(cfg, device="cpu", state=params_from_numpy(cfg, tree))
    batch = JaxPipeline(jm.cfg, seq, batch, seed=3).batch_at(0)
    return jm, jax.tree.map(jnp.asarray, tree), model, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_jax(arch):
    jm, jparams, model, batch = _shared(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def reference(p, b):     # one compile for the loss, grads and logits
        (total, mets), grads = jax.value_and_grad(
            jax_loss_fn(jm), has_aux=True)(p, b)
        return total, mets, grads, jm.forward_train(p, b)

    jtotal, jmets, jgrads, (jlogits, jaux) = jax.jit(reference)(jparams,
                                                               jbatch)

    params = model.train_params()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, aux = model.forward_train(
        tbatch.get("tokens"), embeds=tbatch.get("embeds"),
        image_embeds=tbatch.get("image_embeds"))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-6)
    total, mets = make_loss_fn(model)(tbatch)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(mets["loss"].item(), float(jmets["loss"]),
                               rtol=1e-5)
    grads = torch.autograd.grad(total, list(params.values()))
    jflat = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(params)
    for name, g in zip(params, grads):
        want = jflat[name]
        assert g is not None, name
        if np.abs(want).max() > 0:
            assert g.abs().max() > 0, name
        _close(g.numpy(), want, GRAD_LIMIT)


def test_remat_recomputes_the_kernels_and_keeps_the_gradients():
    """recurrentgemma-2b's smoke stack is one group (RG-LRU, RG-LRU,
    local attention): with remat its forward runs twice, and each RG-LRU
    backward is one more scan call."""
    _, _, model, batch = _shared("recurrentgemma-2b")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = model.train_params()
    out = {}
    for remat in ("none", "full"):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        fa, rg = fa_mod.flash_attention, rg_mod.rglru_scan
        c0 = (fa.plain_calls, rg.plain_calls)
        total, _ = make_loss_fn(model)(tbatch)
        grads = torch.autograd.grad(total, list(params.values()))
        out[remat] = (grads, (fa.plain_calls - c0[0],
                              rg.plain_calls - c0[1]))
    assert out["none"][1] == (1, 2 + 2)
    assert out["full"][1] == (2, 4 + 2)
    for g0, g1 in zip(out["none"][0], out["full"][0]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)
