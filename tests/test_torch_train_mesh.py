"""Training on a mesh (`repro_torch.train.sharding`) against the JAX
package's single-device train step, on the CPU with every shard on the
CPU (``make_serve_mesh(d, m, devices=["cpu"] * n)``):

- 3 `make_train_step` steps over plans 1x2, 2x1, 2x2 and 1x4 from the
  reference's `init_state` carried over by `convert.train_state_from_
  numpy`, for the starcoder2-7b, mamba2-780m, recurrentgemma-2b and
  granite-moe-3b-a800m smoke configs (granite-moe with 2 microbatches:
  the aux loss and the microbatch order), and starcoder2-7b with int8
  gradient compression and 2 microbatches at 1x2, 2x1 and 2x2: every
  step's losses, grad_norm and lr and every param against the JAX
  trajectory, computed once per case;
- the plan's structure: its weights equal the 1x1 model's to the bit;
  the bytes each shard holds equal `ft.elastic.plan_rescale`'s; every
  copy of a replicated slice is equal after each step; the norm counts
  each logical leaf once; the per-shard kernel outputs carry the
  kernels' autograd Functions at per-shard head counts; a remat plan
  equals the plan without remat; the cross-attention and external-
  embedding families at 1x2 against their 1x1 trainer step;
- deliberately broken variants: the other microbatch order (data shards
  first) and a per-shard compression scale land outside the limits;
- MLA and heads the model axis does not divide lay out (their training
  is `test_torch_plan_layouts.py`'s); refusals: a mesh axis the plan
  does not lay shards over, a model row that mixes shared and distinct
  devices, a batch that does not split, a `Model` given a mesh;
- the seam over distinct cards (`AllReduceSum`) with its collective
  emulated on the CPU: values and gradients equal the in-order sum's.

Limits are ``test_torch_train_step.py``'s (fp32): rtol 1e-5 on losses,
the grad norm and lr, atol 2e-5 on params; with compression atol 2e-4 on
params and rtol 1e-4 on the grad norm, which is the norm of the
dequantized gradient: where the two sides' gradients straddle an int8
rounding boundary an element lands one quantum apart, and that moves the
norm (1.7e-5 relative seen at starcoder2-7b's third step, at 2x1, and at
1x1 with one microbatch) as it moves the params. The sequence is
``test_torch_train_step.py``'s 24 positions: at 16, recurrentgemma-2b's
1x1 step itself lands 5.8e-5 from JAX on one ``w_in`` element, whose
first gradient (1e-8, at Adam's eps) is rounding noise on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.train import grad_compression as jgc
from repro.train.optimizer import OptimizerConfig as JaxOC
from repro.train.train_step import init_state as jax_init_state
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.elastic import plan_rescale
from repro_torch.kernels import api
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.common import flatten
from repro_torch.models.transformer import Model
from repro_torch.serve import sharding as serve_sharding
from repro_torch.train import grad_compression as gc
from repro_torch.train import sharding
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.sharding import (ShardedTrainModel, TrainPlan,
                                        shard_opt_state)
from repro_torch.train.train_step import (cross_entropy, init_state,
                                          make_train_step)

OC_ARGS = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10,
           "grad_clip": 0.5}
OC = OptimizerConfig(**OC_ARGS)
SEQ, BATCH, STEPS = 24, 4, 3
PLANS = ((1, 2), (2, 1), (2, 2), (1, 4))
# case -> (arch, microbatches, compression)
CASES = {"starcoder2-7b": ("starcoder2-7b", 1, False),
         "mamba2-780m": ("mamba2-780m", 1, False),
         "recurrentgemma-2b": ("recurrentgemma-2b", 1, False),
         "granite-moe-3b-a800m": ("granite-moe-3b-a800m", 2, False),
         "starcoder2-7b+compression": ("starcoder2-7b", 2, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-sized ops gain nothing from torch's intra-op threads, and
    beside other test workers they cost more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(d, m):
    return make_serve_mesh(d, m, devices=["cpu"] * (d * m))


def batches(cfg):
    pipe = TokenPipeline(cfg, SEQ, BATCH, seed=1)
    return [pipe.batch_at(s) for s in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs():
    """case -> (the reference's initial state as numpy, its trajectory:
    per step (metrics, flat params)); each case computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, nmb, compress = CASES[case]
            jm = JaxModel(jax_smoke(arch))
            jstate = jax_init_state(jm, JaxOC(**OC_ARGS),
                                    jax.random.PRNGKey(0))
            start = jax.tree.map(np.asarray, jstate)
            if compress:
                jstate["grad_comp"] = jax.tree.map(
                    lambda p: jnp.zeros(p.shape, jnp.float32),
                    jstate["params"])
            step = jax.jit(jax_train_step(
                jm, JaxOC(**OC_ARGS), num_microbatches=nmb,
                grad_transform=jgc.make_error_feedback_compressor()
                if compress else None))
            traj = []
            for b in batches(smoke_config(arch)):
                jstate, mets = step(jstate, {k: jnp.asarray(v)
                                             for k, v in b.items()})
                traj.append(({k: float(v) for k, v in mets.items()},
                             flatten(jax.tree.map(np.asarray,
                                                  jstate["params"]))))
            cache[case] = (start, traj)
        return cache[case]

    return get


def plan_run(arch, plan_shape, start_np, nmb, compress, plan_cls=TrainPlan,
             step_fn=None):
    """The port's trajectory on a plan from a reference state: per step
    (metrics, logical params), and the final (model, state)."""
    cfg = smoke_config(arch)
    start = train_state_from_numpy(cfg, start_np)
    plan = plan_cls(cpu_mesh(*plan_shape), cfg)
    model = ShardedTrainModel(cfg, plan, state=start["params"])
    state = {"params": model.train_params(),
             "opt": shard_opt_state(plan, start["opt"])}
    step = (step_fn or make_train_step)(
        model, OC, num_microbatches=nmb,
        grad_transform=gc.make_error_feedback_compressor(plan)
        if compress else None)
    out = []
    for b in batches(cfg):
        state, mets = step(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        out.append(({k: float(v) for k, v in mets.items()},
                    model.logical_params()))
    return out, model, state


def compare(got, want):
    """Max deviations: (metric name -> relative, param -> absolute)."""
    mets, params = {}, {}
    for (gm, gp), (wm, wp) in zip(got, want):
        assert set(gm) == set(wm)
        for k in wm:
            mets[k] = max(mets.get(k, 0.0), abs(gm[k] - wm[k])
                          / max(abs(wm[k]), 1e-7))
        for n in wp:
            params[n] = max(params.get(n, 0.0), float(np.abs(
                gp[n].float().numpy() - wp[n]).max()))
    return mets, params


def assert_within(got, want, compress):
    mets, params = compare(got, want)
    for k, err in mets.items():
        limit = 1e-4 if compress and k == "grad_norm" else 1e-5
        assert err <= limit, (k, err)
    worst = max(params, key=params.get)
    assert params[worst] <= (2e-4 if compress else 2e-5), (worst,
                                                           params[worst])


@pytest.mark.parametrize("case,plan_shape", [
    (case, plan) for case in CASES for plan in PLANS
    if not (CASES[case][2] and plan == (1, 4))],
    ids=lambda x: "%dx%d" % x if isinstance(x, tuple) else x)
def test_plan_trajectory_matches_jax(case, plan_shape, jax_runs):
    arch, nmb, compress = CASES[case]
    start, want = jax_runs(case)
    got, model, state = plan_run(arch, plan_shape, start, nmb, compress)
    assert_within(got, want, compress)
    assert all(int(o["step"]) == STEPS for row in state["opt"] for o in row)
    assert ("grad_comp" in state) == compress
    if arch == "granite-moe-3b-a800m":
        assert all(g[0]["aux_loss"] > 0 for g in got)


def test_other_microbatch_order_fails(jax_runs):
    """Each data shard's own rows split into microbatches (shard first)
    is not the reference's order (global microbatches, each split over
    the shards): the last microbatch's loss and the aux loss differ. The
    plan's step is given its batch reordered so that its microbatch i of
    shard d holds the shard-first block (i, d)."""
    start, want = jax_runs("granite-moe-3b-a800m")

    def shard_first(model, oc, num_microbatches, grad_transform):
        step = make_train_step(model, oc, num_microbatches=num_microbatches,
                               grad_transform=grad_transform)
        dp = model.plan.dp

        def reordered(state, batch):
            n = next(iter(batch.values())).shape[0]
            per = n // dp
            mbs = per // num_microbatches
            order = [d * per + i * mbs + r for i in range(num_microbatches)
                     for d in range(dp) for r in range(mbs)]
            return step(state, {k: v[order] for k, v in batch.items()})

        return reordered

    got, _, _ = plan_run("granite-moe-3b-a800m", (2, 2), start, 2, False,
                         step_fn=shard_first)
    mets, _ = compare(got, want)
    assert mets["loss"] > 1e-3 and mets["aux_loss"] > 1e-5


def test_per_shard_compression_scale_fails(jax_runs):
    """A compression scale from each shard's own slice (not the logical
    leaf's) is another result: params leave the compression limit."""
    start, want = jax_runs("starcoder2-7b+compression")

    class PerShardScale(TrainPlan):
        def leaf_amax(self, parts):
            return [torch.max(torch.abs(p)) for p in parts]

    got, _, _ = plan_run("starcoder2-7b", (2, 2), start, 2, True,
                         plan_cls=PerShardScale)
    _, params = compare(got, want)
    assert max(params.values()) > 2e-4


def _one_by_one(arch):
    """The port's own 1x1 trainer steps: (metrics, params) per step."""
    cfg = smoke_config(arch)
    model = Model(cfg, device="cpu", seed=0)
    state = init_state(model, OC)
    step = make_train_step(model, OC)
    out = []
    for b in batches(cfg):
        state, mets = step(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        out.append(({k: float(v) for k, v in mets.items()},
                    {n: p.detach().numpy().copy()
                     for n, p in state["params"].items()}))
    return out


def _seeded_plan_run(cfg, plan_shape):
    plan = TrainPlan(cpu_mesh(*plan_shape), cfg)
    model = ShardedTrainModel(cfg, plan, seed=0)
    state = init_state(model, OC)
    step = make_train_step(model, OC)
    out = []
    for b in batches(cfg):
        state, mets = step(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        out.append(({k: float(v) for k, v in mets.items()},
                    model.logical_params()))
    return out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_cross_and_external_embedding_plans_match_one_by_one(arch):
    """The cross-attention branch (its tanh gates, q/k norms and image
    keys per head block) and external embeddings train at 1x2 as at
    1x1."""
    got = _seeded_plan_run(smoke_config(arch), (1, 2))
    assert_within(got, _one_by_one(arch), False)


def test_remat_plan_equals_plan_without_remat():
    """Per-group remat over the shards' lists (the gather recomputed
    inside each segment) gives the plan's gradients without remat."""
    import dataclasses
    cfg = smoke_config("recurrentgemma-2b")
    plain = _seeded_plan_run(cfg, (2, 2))
    remat = _seeded_plan_run(dataclasses.replace(cfg, remat="full"), (2, 2))
    for (pm, pp), (rm, rp) in zip(plain, remat):
        assert pm == rm
        for n in pp:
            torch.testing.assert_close(rp[n], pp[n], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "mamba2-780m",
                                  "recurrentgemma-2b",
                                  "granite-moe-3b-a800m"])
def test_plan_weights_and_bytes(arch):
    """The seeded plan's weights are the 1x1 model's to the bit; each
    shard holds `plan_rescale`'s bytes; the replicated slices' copies
    stay equal after every step."""
    cfg = smoke_config(arch)
    want = flatten(Model(cfg, device="cpu", seed=0).params)
    plan = TrainPlan(cpu_mesh(2, 2), cfg)
    model = ShardedTrainModel(cfg, plan, seed=0)
    got = model.logical_params()
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    state = init_state(model, OC)
    held = model.held_bytes(state["opt"])
    counted = plan_rescale(cfg, OC, plan.mesh).bytes_per_device
    assert held == [[counted] * 2] * 2
    # a leaf replicated over data (a bias / norm) is held twice and more
    assert any(len(g[0]) > 1 for g in plan.replicas.values())
    step = make_train_step(model, OC)
    for b in batches(cfg):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        for tree in [state["params"]] + [[[o[k] for o in row]
                                          for row in state["opt"]]
                                         for k in ("m", "v", "master")]:
            for name, groups in plan.replicas.items():
                for group in groups:
                    first = tree[group[0][0]][group[0][1]][name]
                    for d, m in group[1:]:
                        assert torch.equal(tree[d][m][name], first), name


def test_global_norm_counts_each_leaf_once():
    """The norm over a plan's slices is the logical gradient's, though a
    replicated leaf (every norm, the biases, recurrentgemma's MQA wk /
    wv over data) has several copies."""
    cfg = smoke_config("recurrentgemma-2b")
    plan = TrainPlan(cpu_mesh(2, 2), cfg)
    rng = np.random.default_rng(0)
    logical = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for n, s in plan.shapes.items()}
    grads = plan.shard_tree(logical)
    want = torch.sqrt(sum(torch.sum(g * g) for g in logical.values()))
    torch.testing.assert_close(plan.global_norm(grads), want, rtol=1e-6,
                               atol=0)
    rep = [n for n, g in plan.replicas.items()
           if any(len(x) > 1 for x in g)]
    assert "final_norm" in rep and "groups.l2.attn.wk" in rep
    assert plan.specs["groups.l2.attn.wk"] == (None, "data")
    every_copy = torch.sqrt(sum(torch.sum(t * t) for row in grads
                                for shard in row for t in shard.values()))
    assert float(every_copy) > float(want) * 1.01


@pytest.mark.parametrize("arch,plan_shape,kernel,heads", [
    ("starcoder2-7b", (2, 2), "flash_attention", 2),
    ("mamba2-780m", (1, 4), "ssd_scan", 2),
    ("recurrentgemma-2b", (2, 2), "rglru_scan", 32)])
def test_shard_kernels_run_through_their_functions(arch, plan_shape, kernel,
                                                   heads):
    """Every per-shard launch goes through the kernel's autograd Function
    at the shard's width (q heads, SSD heads, RG-LRU columns over the
    model axis) and on the shard's rows."""
    cfg = smoke_config(arch)
    model = ShardedTrainModel(cfg, TrainPlan(cpu_mesh(*plan_shape), cfg))
    model.train_params()
    seen = []
    plain_run = api.run

    def run(name, *args, **kw):
        out = plain_run(name, *args, **kw)
        if name == kernel:
            seen.append((args[0].shape, out[0] if isinstance(out, tuple)
                         else out))
        return out

    batch = {k: torch.from_numpy(v) for k, v in batches(cfg)[0].items()}
    api.run = run
    try:
        loss, _ = model.loss(batch, cross_entropy)
    finally:
        api.run = plain_run
    n_layers = sum(1 for mx, _ in cfg.layer_kinds() if mx in
                   {"flash_attention": ("attn", "local_attn"),
                    "ssd_scan": ("ssd",),
                    "rglru_scan": ("rglru",)}[kernel])
    assert len(seen) == n_layers * plan_shape[0] * plan_shape[1]
    names = {"flash_attention": "FlashAttentionFnBackward",
             "ssd_scan": "SsdScanFnBackward",
             "rglru_scan": "RglruScanFnBackward"}
    for shape, out in seen:
        assert type(out.grad_fn).__name__ == names[kernel]
        assert shape[0] == BATCH // plan_shape[0]
        assert shape[2] == heads
    assert loss.requires_grad


def test_seam_over_distinct_cards_is_differentiable(monkeypatch):
    """`AllReduceSum` (the seam when each model shard has its own card)
    with its NCCL all-reduce emulated in place on the CPU: outputs and
    gradients equal the one-device in-order sum's."""
    def emulated(tensors, op="sum"):
        total = tensors[0].clone()
        for t in tensors[1:]:
            total = total + t
        for t in tensors:
            t.copy_(total)

    monkeypatch.setattr(serve_sharding, "all_reduce_", emulated)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
          for _ in range(3)]
    ws = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
          for _ in range(3)]

    def grads(seam):
        leaves = [x.clone().requires_grad_() for x in xs]
        outs = seam([x * x for x in leaves])
        loss = sum((o * w).sum() for o, w in zip(outs, ws)) + \
            (outs[0] ** 2).sum()
        return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)

    want_out, want_g = grads(lambda p: sharding.ServePlan.psum(p))
    got_out, got_g = grads(lambda p: list(
        sharding.AllReduceSum.apply(*p)))
    for a, b in zip(got_out + list(got_g), want_out + list(want_g)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_plans_refuse():
    """Every config lays out on a ("data", "model") mesh (MLA, heads the
    model axis does not divide), as GSPMD lays out the reference's; other
    mesh axes refuse; a model row is one device or distinct ones; the
    batch must split over data shards x microbatches; a `Model` needs its
    plan."""
    TrainPlan(cpu_mesh(1, 2), smoke_config("minicpm3-4b"))
    plan = TrainPlan(cpu_mesh(1, 3), smoke_config("starcoder2-7b"))
    assert "attn" in plan.serve.whole_sublayers(plan.cfg)
    from repro_torch.launch.mesh import make_abstract_mesh
    with pytest.raises(ValueError, match="lays shards over"):
        TrainPlan(make_abstract_mesh((2, 2), ("data", "expert")),
                  smoke_config("starcoder2-7b"))
    from repro_torch.launch.mesh import Mesh
    mixed = np.empty((1, 3), dtype=object)
    mixed[0] = [torch.device("cpu"), torch.device("cpu"),
                torch.device("meta")]
    with pytest.raises(ValueError, match="model row|one device"):
        TrainPlan(Mesh(mixed, ("data", "model")),
                  smoke_config("mamba2-780m"))
    cfg = smoke_config("starcoder2-7b")
    model = ShardedTrainModel(cfg, TrainPlan(cpu_mesh(2, 1), cfg))
    state = init_state(model, OC)
    step = make_train_step(model, OC, num_microbatches=3)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg)[0].items()}
    with pytest.raises(ValueError, match="does not divide"):
        step(state, b)
    with pytest.raises(ValueError, match="ShardedTrainModel"):
        make_train_step(Model(cfg, device="cpu"), OC, mesh=cpu_mesh(2, 2))
    assert TrainPlan.from_mesh(cpu_mesh(1, 1), cfg) is None
