"""Temperature sampling compared by distribution, as ROADMAP's rules ask
(``jax.random`` and ``torch.Generator`` draw different streams): the
port of ``tests/test_spec_sampling.py``. Identical prompts across a batch
give iid samples of the first decode-step token at T = 0.8; the
empirical proportions of fixed events must agree within a two-proportion
z bound of 4 sigma (plain normal approximation) between the port's k = 1
and k = 4 (self-draft) streams, and between the port's k = 1 stream and
the JAX engine's on the same weights. A biased acceptance rule, or a
port that samples from other logits, shifts these proportions far past
the bound; at 4 sigma a false failure of the whole test is below ~1e-3.
"""
import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCH = "starcoder2-7b"
BATCH = 64
SEEDS = (0, 1, 2)
TEMPERATURE = 0.8
SIGMAS = 4.0


@pytest.fixture(scope="module")
def samples():
    """Pooled samples of the FIRST decode-step token (output index 1)
    over identical prompts, BATCH rows x len(SEEDS) calls: the port at
    k = 1 and k = 4, the JAX engine at k = 1."""
    jparams = JaxEngine(jax_smoke(ARCH)).params
    state = params_from_numpy(smoke_config(ARCH),
                              jax.tree.map(np.asarray, jparams))
    prompt = np.random.default_rng(42).integers(
        0, smoke_config(ARCH).vocab_size, 8).astype(np.int32)

    def draw(eng, cls):
        out = []
        for seed in SEEDS:
            outs = eng.generate([cls(prompt.copy(), 3) for _ in range(BATCH)],
                                greedy=False, temperature=TEMPERATURE,
                                seed=seed, free_pages=True)
            out.extend(int(o[1]) for o in outs)
        return np.asarray(out)

    port = {k: draw(ServeEngine(smoke_config(ARCH), params=state,
                                kv_pool=PagedKVPool(page_tokens=8),
                                device="cpu", speculate=k,
                                draft="self" if k > 1 else "ngram"), Request)
            for k in (1, 4)}
    jax_k1 = draw(JaxEngine(jax_smoke(ARCH), params=jparams,
                            kv_pool=JaxPool(page_tokens=8),
                            decode_mode="fused"), JaxRequest)
    return port[1], port[4], jax_k1


def _two_proportion_bound(hit1, hit2, n1, n2) -> tuple:
    p1, p2 = hit1 / n1, hit2 / n2
    pooled = (hit1 + hit2) / (n1 + n2)
    se = np.sqrt(max(pooled * (1 - pooled), 1e-12) * (1 / n1 + 1 / n2))
    return abs(p1 - p2), SIGMAS * se + 1e-9


def _same_distribution(tok_a, tok_b):
    vocab = smoke_config(ARCH).vocab_size
    n_a, n_b = len(tok_a), len(tok_b)
    assert n_a == n_b == BATCH * len(SEEDS)
    # both streams stay in-vocab and actually sample (not degenerate)
    for tok in (tok_a, tok_b):
        assert tok.min() >= 0 and tok.max() < vocab
        assert len(np.unique(tok)) > 1
    # the events partition the vocab at different granularities, so a
    # shifted distribution cannot hide from all of them
    mode = np.bincount(np.concatenate([tok_a, tok_b])).argmax()
    for name, event in (("below_half", lambda t: t < vocab // 2),
                        ("below_quarter", lambda t: t < vocab // 4),
                        ("is_mode", lambda t: t == mode)):
        diff, bound = _two_proportion_bound(
            int(event(tok_a).sum()), int(event(tok_b).sum()), n_a, n_b)
        assert diff <= bound, (name, diff, bound)


def test_verify_sampling_matches_k1_distribution(samples):
    port_k1, port_k4, _ = samples
    _same_distribution(port_k1, port_k4)


def test_port_sampling_matches_jax_distribution(samples):
    port_k1, _, jax_k1 = samples
    _same_distribution(port_k1, jax_k1)
