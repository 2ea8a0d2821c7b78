"""The elastic plan, logical checkpoints across plans and the compressed
psum, on the CPU:

- `ft.elastic.plan_rescale` against the reference's on
  ``make_host_mesh()`` (one device): ok, bytes and every leaf's spec;
- its bytes and specs against a sum over the reference's own `spec_for`
  on abstract 2x2, 1x4 and 16x16 meshes at full width (starcoder2-7b at
  8 layers, mamba2-780m, recurrentgemma-2b, granite-moe-3b-a800m), and
  the 2x2 / 1x1 state sizes of the training plan's full-width configs;
- `abstract_state` / `abstract_batch` with a mesh: each leaf's `P` the
  reference's `spec_for`;
- a `Trainer(mesh=)` run at 2x2 checkpoints logical leaves; resumed at
  2x2 it equals the straight 2x2 run to the bit, resumed at 1x2 and 1x1
  it is within the train-step limits (rtol 1e-5 on losses and the grad
  norm, atol 2e-5 on params);
- `compressed_psum` / `data_parallel_mean_compressed` against JAX's on a
  one-device mesh, and at 2 and 4 CPU shards against a numpy sum of the
  dequantized int8 parts (rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import smoke_config as jax_smoke
from repro.ft.elastic import plan_rescale as jax_plan_rescale
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import Model as JaxModel
from repro.sharding.partition import batch_logical as jax_batch_logical
from repro.sharding.partition import spec_for as jax_spec_for
from repro.train import grad_compression as jgc
from repro.train.optimizer import OptimizerConfig as JaxOC
from repro.train.train_step import abstract_state as jax_abstract_state
from repro_torch.configs import get_config, smoke_config
from repro_torch.ft.elastic import HBM_BYTES, plan_rescale
from repro_torch.launch.mesh import (make_abstract_mesh, make_host_mesh,
                                     make_serve_mesh)
from repro_torch.models.common import flatten
from repro_torch.sharding.partition import Sharded
from repro_torch.train import grad_compression as gc
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import abstract_batch, abstract_state
from repro_torch.train.trainer import Trainer, TrainJobConfig

FULL = (("starcoder2-7b", 8), ("mamba2-780m", None),
        ("recurrentgemma-2b", None), ("granite-moe-3b-a800m", None))
MESHES = ((2, 2), (1, 4), (16, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, layers):
    kw = {"num_layers": layers} if layers else {}
    return get_config(arch, **kw), jax_config(arch, **kw)


def _reference_leaves(jcfg, mesh):
    """The reference's state leaves: flat name -> (shape, itemsize, spec
    as a tuple) by its own `spec_for`."""
    model = JaxModel(jcfg)
    abstract = jax_abstract_state(model, JaxOC(), None)
    logical = {"params": model.logical(),
               "opt": {"step": (), "m": model.logical(),
                       "v": model.logical(), "master": model.logical()}}
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        keys = [p.key for p in path]
        lg = logical
        for k in keys:
            lg = lg[k]
        out[".".join(keys)] = (tuple(leaf.shape), leaf.dtype.itemsize,
                               tuple(jax_spec_for(leaf.shape, lg, mesh)))
    return out


def _port_leaves(plan):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = v

    walk(plan.shardings, "")
    return out


def test_plan_rescale_matches_reference_on_host_mesh():
    for arch in ("codeqwen1.5-7b", "mamba2-780m", "granite-moe-3b-a800m"):
        want = jax_plan_rescale(JaxModel(jax_smoke(arch)), JaxOC(),
                                jax_host_mesh())
        got = plan_rescale(smoke_config(arch), OptimizerConfig(),
                           make_host_mesh(["cpu"]), hbm_bytes=16 * 2 ** 30)
        assert got.ok and want.ok
        assert got.bytes_per_device == want.bytes_per_device > 0
    # the default budget is the card's memory; a budget under the state
    # refuses it
    assert HBM_BYTES == 85017493504
    small = plan_rescale(smoke_config("codeqwen1.5-7b"), OptimizerConfig(),
                         make_host_mesh(["cpu"]), hbm_bytes=1024)
    assert not small.ok and "exceeds HBM budget" in small.reasons[0]


@pytest.mark.parametrize("arch,layers", FULL)
def test_plan_rescale_bytes_and_specs_match_reference(arch, layers):
    cfg, jcfg = _configs(arch, layers)
    for shape in MESHES:
        mesh = make_abstract_mesh(shape, ("data", "model"))
        want = _reference_leaves(jcfg, jax_abstract_mesh(shape,
                                                         ("data", "model")))
        plan = plan_rescale(cfg, OptimizerConfig(), mesh)
        got = _port_leaves(plan)
        assert set(got) == set(want)
        for name, (_, _, spec) in want.items():
            assert tuple(got[name]) == spec, (name, shape)
        total = 0
        for name, (leaf_shape, itemsize, spec) in want.items():
            factor = 1
            for e in spec:
                for ax in (() if e is None else
                           (e if isinstance(e, tuple) else (e,))):
                    factor *= dict(zip(("data", "model"), shape))[ax]
            total += int(np.prod(leaf_shape)) * itemsize // factor
        assert plan.bytes_per_device == total, shape


@pytest.mark.parametrize("arch,layers,gb_2x2,gb_1x1", [
    ("starcoder2-7b", 8, 7.66, 30.65), ("mamba2-780m", None, 3.01, 12.01),
    ("recurrentgemma-2b", None, 13.29, 49.70)])
def test_training_plan_state_sizes(arch, layers, gb_2x2, gb_1x1):
    """The state a shard holds at full width (params, master, m, v: 14
    bytes a parameter, bf16 params), at 2x2 and 1x1."""
    cfg, _ = _configs(arch, layers)
    oc = OptimizerConfig()
    two = plan_rescale(cfg, oc, make_abstract_mesh((2, 2), ("data",
                                                           "model")))
    one = plan_rescale(cfg, oc, make_abstract_mesh((1, 1), ("data",
                                                           "model")))
    assert round(two.bytes_per_device / 1e9, 2) == gb_2x2
    assert round(one.bytes_per_device / 1e9, 2) == gb_1x1
    assert two.ok and one.ok == (one.bytes_per_device <= HBM_BYTES)
    # recurrentgemma-2b's 10 heads do not split over 4 model shards: the
    # plan runs its attention whole on each, and the verdict is memory's
    # alone, as the reference's
    four = plan_rescale(cfg, oc, make_abstract_mesh((1, 4), ("data",
                                                            "model")))
    assert four.ok and not four.reasons


def test_abstract_state_and_batch_on_a_mesh():
    cfg = smoke_config("recurrentgemma-2b")
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    jmesh = jax_abstract_mesh((2, 2), ("data", "model"))
    want = _reference_leaves(jax_smoke("recurrentgemma-2b"), jmesh)
    state = abstract_state(cfg, OptimizerConfig(), mesh)
    flat = flatten(state)
    assert set(flat) == set(want)
    for name, leaf in flat.items():
        assert isinstance(leaf, Sharded) and leaf.meta.is_meta
        assert tuple(leaf.meta.shape) == want[name][0]
        assert tuple(leaf.spec) == want[name][2], name
    batch = abstract_batch(cfg, 24, 8, mesh)
    jlog = jax_batch_logical(jax_smoke("recurrentgemma-2b"), "train")
    for k, leaf in batch.items():
        assert tuple(leaf.spec) == tuple(jax_spec_for(
            tuple(leaf.meta.shape), jlog[k], jmesh)) == ("data",)
    assert set(abstract_state(cfg, OptimizerConfig())) == {"params", "opt"}


def _job(d, steps):
    return TrainJobConfig(steps=steps, seq_len=24, global_batch=4,
                          checkpoint_every=3, checkpoint_dir=str(d),
                          async_checkpoint=False, log_every=100)


def _mesh(d, m):
    return make_serve_mesh(d, m, devices=["cpu"] * (d * m))


def _logical_params(tr, out) -> dict:
    if tr.plan is not None:
        return tr.model.logical_params()
    return {n: p.detach() for n, p in out["state"]["params"].items()}


def test_checkpoint_resumes_on_any_plan(tmp_path):
    """Straight 6 steps at 2x2; 3 steps at 2x2 and the checkpoint resumed
    at 2x2 (to the bit), 1x2 and 1x1 (within the step limits)."""
    import shutil
    cfg = smoke_config("granite-moe-3b-a800m")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                         grad_clip=0.5)
    tr = Trainer(cfg, oc, _job(tmp_path / "straight", 6), mesh=_mesh(2, 2))
    out = tr.run()
    want, final = out["history"][3:], _logical_params(tr, out)
    first = Trainer(cfg, oc, _job(tmp_path / "ckpt", 3), mesh=_mesh(2, 2))
    first.run()
    at_3 = first.model.logical_params()
    for shape in ((2, 2), (1, 2), (1, 1)):
        d = tmp_path / f"resume_{shape[0]}x{shape[1]}"
        shutil.copytree(tmp_path / "ckpt", d)
        tr = Trainer(cfg, oc, _job(d, 6), mesh=_mesh(*shape), device="cpu")
        out = tr.run()
        assert (tr.plan is None) == (shape == (1, 1))
        assert [h["step"] for h in out["history"]] == [3, 4, 5]
        for got, exp in zip(out["history"], want):
            for k in ("total_loss", "loss", "aux_loss", "grad_norm", "lr"):
                if shape == (2, 2):
                    assert got[k] == exp[k], k
                else:
                    np.testing.assert_allclose(got[k], exp[k], rtol=1e-5,
                                               err_msg=k)
        for n, p in _logical_params(tr, out).items():
            if shape == (2, 2):
                assert torch.equal(p, final[n]), n
            else:
                np.testing.assert_allclose(p.numpy(), final[n].numpy(),
                                           rtol=0, atol=2e-5, err_msg=n)
    # the checkpoint holds the logical leaves: a 1x1 restore template
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.train.train_step import state_tree
    tree, meta = Checkpointer(tmp_path / "ckpt").restore(
        state_tree(abstract_state(cfg, oc)), device="cpu")
    assert meta["step"] == 3
    for n, p in flatten(tree["params"]).items():
        assert torch.equal(p, at_3[n]), n


def _quantized_sum(parts):
    """numpy: sum over parts of scale_i * int8 q_i, each part with its own
    symmetric scale max |x| / 127."""
    total = np.zeros_like(parts[0], dtype=np.float32)
    for x in parts:
        amax = np.float32(np.abs(x).max())
        scale = np.float32(amax / np.float32(127.0)) if amax > 0 \
            else np.float32(1.0)
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        total = total + scale * q.astype(np.float32)
    return total


def test_compressed_mean_matches_jax_on_one_device():
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((3, 5)).astype(np.float32) * 3,
             "b": rng.standard_normal((7,)).astype(np.float32),
             "z": np.zeros((4,), np.float32)}
    want = jgc.data_parallel_mean_compressed(
        {k: jnp.asarray(v) for k, v in grads.items()}, jax_host_mesh())
    got = gc.data_parallel_mean_compressed(
        [{k: torch.from_numpy(v) for k, v in grads.items()}],
        make_host_mesh(["cpu"]))
    assert len(got) == 1
    for k in grads:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_over_shards(n):
    """Every shard's sum is the dequantized int8 parts' (int8 on the
    wire, one fp32 scale a part), and the mean divides by the shards."""
    rng = np.random.default_rng(n)
    parts = [(rng.standard_normal((6, 5)) * (i + 1)).astype(np.float32)
             for i in range(n)]
    want = _quantized_sum(parts)
    got = gc.compressed_psum([torch.from_numpy(p) for p in parts])
    assert len(got) == n
    for g in got:
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-6)
    q, scale = gc.quantize_int8(torch.from_numpy(parts[0]))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    means = gc.data_parallel_mean_compressed(
        [{"g": torch.from_numpy(p)} for p in parts],
        make_host_mesh(["cpu"] * n))
    for m in means:
        np.testing.assert_allclose(m["g"].numpy(), want / n, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="shards"):
        gc.data_parallel_mean_compressed([{"g": torch.zeros(2)}],
                                         make_host_mesh(["cpu"] * n))
