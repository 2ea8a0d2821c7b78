"""The layouts `sharding.partition.spec_for` resolves that the plan's
first slices lacked, on the CPU with every shard on the CPU:

- training (`make_train_step` over `TrainPlan`, 3 steps from the
  reference's `init_state` carried over) of (a) a head axis the model
  axis does not divide (starcoder2-7b smoke with 6 q / 2 kv heads at 1x4
  and 2x4: attention whole on every shard), (b) kv heads it does not
  divide under q heads it does (qwen3-moe-30b-a3b smoke with 8 q / 2 kv
  heads at 1x4 and 2x4: each shard's q block reads one kv head), (c) MLA
  (minicpm3-4b smoke at 1x2, 2x2, 1x4, 2x4: latents whole, heads split):
  losses, grad norms, lr and params against the port's 1x1 trainer and
  JAX's within `test_torch_train_step.py`'s limits (rtol 1e-5, atol
  2e-5), but for MLA against JAX atol 5e-5 on params: the port's own
  1x1 MLA trainer lands 2.7e-5 from JAX on one ``mlp.down`` element
  after 3 steps (the limit of the plan against the 1x1 port stays
  2e-5); `Trainer(mesh=)` on (a);
- (e) sequence parallelism (the ``seq_parallel`` variant's rules:
  positions split over the model shards between sublayers, each
  sublayer's input gathered and its output reduce-scattered) trained the
  same way: the starcoder2-7b smoke at 1x2 and 2x2, mamba2-780m's at
  1x4;
- (d) one decode step over caches whose positions split over the model
  shards (8 q / 2 kv heads at 1x4, MLA's latents at 1x2 and 2x2, a
  sliding-window ring of one kv head at 1x2) against the 1x1 model's
  decode (held to the reference's by `test_torch_mla.py` and
  `test_torch_model.py`), fp32 logits within 1e-4, and the step's row
  written to its owner's slice;
- minicpm3-4b's dense `generate` on 1x2 and 2x2 plans: tokens equal the
  JAX engine's on one device;
- `ft.elastic.plan_rescale`: the verdict of every arch on 1x4, 2x4 and
  16 x 16 is the reference's (its bytes over its own specs, the same
  budget), memory alone;
- a deliberately broken seam (the psum of a whole-head mixer left in)
  lands outside the limits.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.sharding.partition import spec_for as jax_spec_for
from repro.train.optimizer import OptimizerConfig as JaxOC
from repro.train.train_step import abstract_state as jax_abstract_state
from repro.train.train_step import init_state as jax_init_state
from repro.train.train_step import make_train_step as jax_train_step
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.elastic import plan_rescale
from repro_torch.launch.mesh import make_abstract_mesh, make_serve_mesh
from repro_torch.models import transformer
from repro_torch.models.common import flatten
from repro_torch.models.transformer import Model, pad_caches
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.sharding import (ShardedTrainModel, TrainPlan,
                                        shard_opt_state)
from repro_torch.train.train_step import init_state, make_train_step

OC_ARGS = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10,
           "grad_clip": 0.5}
OC = OptimizerConfig(**OC_ARGS)
SEQ, BATCH, STEPS = 24, 4, 3
# case -> (arch, config overrides, plans[, variant of the storage rules])
CASES = {
    "a-whole-heads": ("starcoder2-7b", {"num_heads": 6, "num_kv_heads": 2},
                      ((1, 4), (2, 4))),
    "b-mapped-kv": ("qwen3-moe-30b-a3b", {"num_heads": 8, "num_kv_heads": 2},
                    ((1, 4), (2, 4))),
    "c-mla": ("minicpm3-4b", {}, ((1, 2), (2, 2), (1, 4), (2, 4))),
    "e-seq-parallel": ("starcoder2-7b", {}, ((1, 2), (2, 2)),
                       "seq_parallel"),
    "e-seq-parallel-ssd": ("mamba2-780m", {}, ((1, 4),), "seq_parallel"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(d, m):
    return make_serve_mesh(d, m, devices=["cpu"] * (d * m))


def configs(case):
    arch, kw = CASES[case][:2]
    return (dataclasses.replace(smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def rules(case):
    """The case's storage rules (a variant's), or None."""
    if len(CASES[case]) < 4:
        return None
    from repro_torch.launch import variants
    return variants.apply(CASES[case][3], configs(case)[0])[1]


def batches(cfg):
    pipe = TokenPipeline(cfg, SEQ, BATCH, seed=1)
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
            for s in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs():
    """case -> (the reference's initial state as numpy, its trajectory);
    each case computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg, jcfg = configs(case)
            jm = JaxModel(jcfg)
            jstate = jax_init_state(jm, JaxOC(**OC_ARGS),
                                    jax.random.PRNGKey(0))
            start = jax.tree.map(np.asarray, jstate)
            step = jax.jit(jax_train_step(jm, JaxOC(**OC_ARGS)))
            traj = []
            for b in batches(cfg):
                jstate, mets = step(jstate, {k: v.numpy()
                                             for k, v in b.items()})
                traj.append(({k: float(v) for k, v in mets.items()},
                             flatten(jax.tree.map(np.asarray,
                                                  jstate["params"]))))
            cache[case] = (start, traj)
        return cache[case]

    return get


def run(cfg, start_np, plan_shape=None, plan_rules=None):
    """The port's trajectory from a reference state: per step (metrics,
    logical params as numpy), at 1x1 or on a plan."""
    start = train_state_from_numpy(cfg, start_np)
    if plan_shape is None:
        model = Model(cfg, device="cpu", state=start["params"])
        state = {"params": model.train_params(),
                 "opt": {k: v for k, v in start["opt"].items()}}
        params = lambda: {n: p.detach().clone()
                          for n, p in state["params"].items()}
    else:
        plan = TrainPlan(cpu_mesh(*plan_shape), cfg, plan_rules)
        model = ShardedTrainModel(cfg, plan, state=start["params"])
        state = {"params": model.train_params(),
                 "opt": shard_opt_state(plan, start["opt"])}
        params = model.logical_params
    step = make_train_step(model, OC)
    out = []
    for b in batches(cfg):
        state, mets = step(state, b)
        out.append(({k: float(v) for k, v in mets.items()},
                    {n: t.float().numpy() for n, t in params().items()}))
    return out


def deviations(got, want):
    mets, params = {}, {}
    for (gm, gp), (wm, wp) in zip(got, want):
        for k in wm:
            mets[k] = max(mets.get(k, 0.0), abs(gm[k] - wm[k])
                          / max(abs(wm[k]), 1e-7))
        for n in wp:
            params[n] = max(params.get(n, 0.0),
                            float(np.abs(gp[n] - wp[n]).max()))
    return max(mets.values()), max(params.values())


@pytest.mark.parametrize("case,plan_shape", [
    (c, p) for c in CASES for p in CASES[c][2]],
    ids=lambda x: "%dx%d" % x if isinstance(x, tuple) else x)
def test_layout_trains_as_one_device(case, plan_shape, jax_runs):
    cfg, _ = configs(case)
    start, want = jax_runs(case)
    got = run(cfg, start, plan_shape, rules(case))
    one = run(cfg, start)
    for ref, limit in ((one, 2e-5),
                       (want, 5e-5 if case == "c-mla" else 2e-5)):
        met, par = deviations(got, ref)
        assert met <= 1e-5 and par <= limit, (met, par)
    plan = TrainPlan(cpu_mesh(*plan_shape), cfg, rules(case))
    assert plan.seq_parallel == case.startswith("e-")
    whole = plan.serve.whole_sublayers(cfg)
    assert ("attn" in whole) == (case == "a-whole-heads")
    assert plan.compute_specs["groups.l0.mla.wdq"] == () \
        if case == "c-mla" else True


def test_kv_block_maps_each_q_block():
    """8 q / 2 kv heads on 4 shards: shard m reads kv head m // 2; 6 q /
    2 kv on 3 shards: shard 1's q heads 2, 3 read kv heads 0, 1 (group
    size 1); 12 q / 3 kv on 4 shards: shard 1's q heads 3, 4, 5 read kv
    heads 0, 1, 1 (a list); kv heads the axis divides: no block."""
    from repro_torch.models.attention import kv_block
    cfg = configs("b-mapped-kv")[0]
    assert [kv_block(cfg, 4, m) for m in range(4)] == [
        slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]
    cfg6 = dataclasses.replace(cfg, num_heads=6)
    assert [kv_block(cfg6, 3, m) for m in range(3)] == [
        slice(0, 1), slice(0, 2), slice(1, 2)]
    cfg12 = dataclasses.replace(cfg, num_heads=12, num_kv_heads=3)
    assert kv_block(cfg12, 4, 1) == [0, 1, 1]
    assert kv_block(cfg, 2, 0) is None


def test_broken_seam_fails(jax_runs, monkeypatch):
    """Summing the copies of a whole-head mixer (tp of them) is not the
    one-device step."""
    cfg, _ = configs("a-whole-heads")
    start, want = jax_runs("a-whole-heads")
    monkeypatch.setattr(transformer, "_whole_heads",
                        lambda cfg, kind, p: False)
    got = run(cfg, start, (1, 4))
    met, par = deviations(got, want)
    assert met > 1e-3


def test_trainer_on_a_mesh_that_does_not_divide_heads(tmp_path):
    from repro_torch.train.trainer import Trainer, TrainJobConfig
    cfg, _ = configs("a-whole-heads")
    job = TrainJobConfig(steps=2, seq_len=SEQ, global_batch=BATCH,
                         checkpoint_dir=str(tmp_path), checkpoint_every=100)
    tr = Trainer(cfg, OC, job, mesh=cpu_mesh(1, 4))
    out = tr.run()
    assert np.isfinite(out["final_metrics"]["loss"])


# ---------------------------------------------------------------------------
# (d): a decode step over caches split by positions
# ---------------------------------------------------------------------------
def _decode_pair(cfg, plan_shape, seed=0, plen=5, cap=8):
    """(1x1 logits, plan logits, 1x1 caches, plan caches) of one decode
    step at position `plen` after a prefill of `plen` tokens, the plan's
    attention / MLA caches the 1x1 caches cut by positions."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, plen + 1), generator=g,
                         dtype=torch.int32)
    model = Model(cfg, device="cpu", seed=0)
    _, caches = model.forward_prefill(toks[:, :plen])
    caches = pad_caches(caches, cap, cfg)
    plan = TrainPlan(cpu_mesh(*plan_shape), cfg)
    sm = ShardedTrainModel(cfg, plan, seed=0)
    _, shard_caches = sm.run(0, {"tokens": toks[:, :plen]}, mode="prefill")
    tp = plan.tp
    per_shard = [pad_caches([c[m] for c in shard_caches], cap, cfg)
                 for m in range(tp)]
    split = []
    for layer, c in enumerate(caches):
        row = []
        for m in range(tp):
            mine = per_shard[m][layer]
            for name in ("k", "v", "ckv", "krope"):
                if name in c:
                    L = c[name].shape[1] // tp
                    mine[name] = c[name][:, m * L:(m + 1) * L].clone()
                    mine["seq_split"] = True
            row.append(mine)
        split.append(row)
    want = model.forward_decode(toks[:, plen:], caches, plen)
    got, split = sm.run(0, {"tokens": toks[:, plen:]}, mode="decode",
                        caches=split, pos=plen)
    return want, got, caches, split


@pytest.mark.parametrize("arch,kw,plan_shape", [
    ("starcoder2-7b", {"num_heads": 8, "num_kv_heads": 2}, (1, 4)),
    ("starcoder2-7b", {"num_heads": 6, "num_kv_heads": 2}, (1, 4)),
    ("minicpm3-4b", {}, (1, 2)),
    ("minicpm3-4b", {}, (2, 2)),
    ("recurrentgemma-2b", {"window": 8}, (1, 2))])
def test_decode_over_split_positions(arch, kw, plan_shape):
    cfg = dataclasses.replace(smoke_config(arch), **kw)
    want, got, caches, split = _decode_pair(cfg, plan_shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=0)
    # the step's row went to the shard that owns position 5
    for c, row in zip(caches, split):
        for name in ("k", "ckv"):
            if name in c:
                L = row[0][name].shape[1]
                np.testing.assert_allclose(
                    row[5 // L][name][:, 5 % L].numpy(),
                    c[name][:, 5].numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# minicpm3-4b's dense generate over a plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan_shape", [(1, 2), (2, 2)])
def test_mla_dense_generate_matches_jax(plan_shape):
    import jax.numpy as jnp
    from repro.serve.engine import Request as JaxRequest
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve.engine import Request, ServeEngine
    jm = JaxModel(jax_smoke("minicpm3-4b"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 5, 7)]
    want = JaxEngine(jax_smoke("minicpm3-4b"),
                     params=jax.tree.map(jnp.asarray, tree)).generate(
        [JaxRequest(p, 6) for p in prompts])
    eng = ServeEngine(smoke_config("minicpm3-4b"),
                      params=params_from_numpy(smoke_config("minicpm3-4b"),
                                               tree),
                      mesh=cpu_mesh(*plan_shape))
    got = eng.generate([Request(p, 6) for p in prompts])
    assert [list(map(int, g)) for g in got] == \
        [list(map(int, w)) for w in want]
    assert eng.stats["decode_steps"] == 5


# ---------------------------------------------------------------------------
# elastic verdicts
# ---------------------------------------------------------------------------
def _reference_verdict(arch, shape, budget):
    """The reference's `plan_rescale` verdict: its state's bytes per
    device over its own specs against the budget."""
    model = JaxModel(jax_config(arch))
    abstract = jax_abstract_state(model, JaxOC(), None)
    lg = model.logical()
    logical = {"params": lg, "opt": {"step": (), "m": lg, "v": lg,
                                     "master": lg}}
    mesh = jax_abstract_mesh(shape, ("data", "model"))
    sizes = dict(zip(("data", "model"), shape))
    total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        node = logical
        for p in path:
            node = node[p.key]
        factor = 1
        for e in jax_spec_for(leaf.shape, node, mesh):
            if e is not None:
                for ax in (e if isinstance(e, tuple) else (e,)):
                    factor *= sizes[ax]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // factor
    return total <= budget, total


@pytest.mark.parametrize("arch", list_archs())
def test_plan_rescale_verdicts_are_the_reference(arch):
    budget = 16 * 2 ** 30
    for shape in ((1, 4), (2, 4), (16, 16)):
        got = plan_rescale(get_config(arch), OptimizerConfig(),
                           make_abstract_mesh(shape, ("data", "model")),
                           hbm_bytes=budget)
        ok, total = _reference_verdict(arch, shape, budget)
        assert (got.ok, got.bytes_per_device) == (ok, total), (arch, shape)
        assert all("HBM budget" in r for r in got.reasons)
