"""The port's partition rules, meshes and serve plan against the JAX
package's, on the CPU with no device:

- every parameter's spec from the port's `spec_for` equals ``tuple()`` of
  the reference's, for the ten full configs and their smoke configs,
  under ``DEFAULT_RULES`` and ``SERVE_RULES``, on abstract 16 x 16 and
  2 x 16 x 16 meshes; `ServePlan.param_specs` equals the reference's on
  serve plans 1x2, 2x2 and 2x4;
- `ServePlan.check_config` accepts and refuses exactly what the
  reference's does, with the same message; `pad_rows`, `shard_of_row`,
  `pool_specs` (heads replicated or not) and `head_sharded_specs`;
- a hypothesis property, as ``tests/test_properties.py``: no mesh axis
  is used twice in one leaf, and every used axis divides its dimension;
- `launch.dryrun.serve_plan_cell` equals the reference's for every arch
  at five serve meshes, given the reference's TPU hardware numbers;
  ``--serve-plan`` writes its records;
- the mesh constructors: a serve mesh asking for more CUDA devices than
  exist raises `ValueError`, devices may repeat, a model row must be one
  device or distinct ones.
"""
import json
import math
import os

import jax
import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.configs import smoke_config as jax_smoke
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models.transformer import Model as JaxModel
from repro.serve.sharding import ServePlan as JaxPlan
from repro.sharding import partition as jax_partition
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.roofline import Hardware
from repro_torch.kernels.paged_attention.spec import head_sharded_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_abstract_mesh, make_host_mesh,
                                     make_production_mesh, make_serve_mesh)
from repro_torch.models.common import flatten
from repro_torch.models.transformer import model_logical, model_spec
from repro_torch.serve.sharding import ServePlan, plan_param_bytes
from repro_torch.sharding import partition

ARCHS = list_archs()
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
SERVE_MESHES = ((1, 1), (1, 2), (2, 2), (1, 4), (2, 4))


def _configs(arch):
    return ((get_config(arch), jax_config(arch)),
            (smoke_config(arch), jax_smoke(arch)))


def _jax_flat(tree) -> dict:
    """A nested dict of reference specs as ``{name: tuple}``."""
    return {n: tuple(s) for n, s in flatten(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference(arch):
    for cfg, jcfg in _configs(arch):
        jmodel = JaxModel(jcfg)
        jshapes = _jax_flat(jax.tree.map(
            lambda a: a.shape, jmodel.abstract_params()))
        jlogical = flatten(jmodel.logical())
        shapes = {n: ps.shape for n, ps in flatten(model_spec(cfg)).items()}
        logical = model_logical(cfg)
        assert shapes == jshapes and logical == jlogical
        for shape, axes in MESHES:
            mesh, jmesh = (make_abstract_mesh(shape, axes),
                           jax_abstract_mesh(shape, axes))
            for rules in ("DEFAULT_RULES", "SERVE_RULES"):
                for n in shapes:
                    got = partition.spec_for(shapes[n], logical[n], mesh,
                                             getattr(partition, rules))
                    want = jax_partition.spec_for(
                        shapes[n], jlogical[n], jmesh,
                        getattr(jax_partition, rules))
                    assert got == tuple(want), (cfg.name, rules, n)
                    assert isinstance(got, partition.P)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_param_specs_match_reference(arch):
    for cfg, jcfg in _configs(arch):
        jmodel = JaxModel(jcfg)
        for d, m in ((1, 2), (2, 2), (2, 4)):
            plan = ServePlan(make_abstract_mesh((d, m), ("data", "model")))
            jplan = JaxPlan(jax_abstract_mesh((d, m), ("data", "model")))
            assert plan.param_specs(cfg) == _jax_flat(
                jplan.param_specs(jmodel)), (cfg.name, d, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_check_config_matches_reference(arch):
    for cfg, jcfg in _configs(arch):
        for tp in (1, 2, 3, 4, 8, 16):
            outs = []
            for plan_cls, mk, c in ((ServePlan, make_abstract_mesh, cfg),
                                    (JaxPlan, jax_abstract_mesh, jcfg)):
                plan = plan_cls(mk((2, tp), ("data", "model")))
                try:
                    plan.check_config(c)
                    outs.append(None)
                except ValueError as e:
                    outs.append(str(e))
            assert outs[0] == outs[1], (cfg.name, tp)
    # recurrentgemma-2b's 10 heads refuse a 1x4 plan
    plan = ServePlan(make_abstract_mesh((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match="num_heads=10"):
        plan.check_config(get_config("recurrentgemma-2b"))


@pytest.mark.parametrize("d,m", [(1, 2), (2, 2), (2, 4), (4, 1), (8, 1)])
def test_rows_and_pool_specs_match_reference(d, m):
    plan = ServePlan(make_abstract_mesh((d, m), ("data", "model")))
    jplan = JaxPlan(jax_abstract_mesh((d, m), ("data", "model")))
    assert (plan.dp, plan.tp) == (jplan.dp, jplan.tp)
    for n in range(1, 13):
        assert plan.pad_rows(n) == jplan.pad_rows(n)
        rows = plan.pad_rows(n)
        assert [plan.shard_of_row(i, rows) for i in range(rows)] == \
            [jplan.shard_of_row(i, rows) for i in range(rows)]
    for rep in (False, True):
        assert plan.pool_specs(rep) == tuple(
            tuple(s) for s in jplan.pool_specs(rep))
    # a data-only mesh replicates the model axis away
    plan1 = ServePlan(make_abstract_mesh((d,), ("data",)))
    jplan1 = JaxPlan(jax_abstract_mesh((d,), ("data",)))
    assert plan1.pool_specs() == tuple(tuple(s)
                                       for s in jplan1.pool_specs())


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("layer_stacked", [True, False])
def test_head_sharded_specs_match_reference(k, layer_stacked):
    from repro.kernels.paged_attention.spec import \
        head_sharded_specs as jax_specs
    got = head_sharded_specs(k, layer_stacked=layer_stacked)
    want = jax_specs(k, layer_stacked=layer_stacked)
    assert got == {n: tuple(s) for n, s in want.items()}


def test_partition_spec_and_batch_logical():
    assert partition.P("data", None) == ("data", None)
    assert repr(partition.P("data", ("pod", "model"))) == \
        "P('data', ('pod', 'model'))"
    mesh = make_production_mesh(multi_pod=True)
    assert partition.dp_axes(mesh) == jax_partition.dp_axes(
        jax_abstract_mesh((2, 16, 16), ("pod", "data", "model")))
    for arch in ("starcoder2-7b", "musicgen-medium",
                 "llama-3.2-vision-11b"):
        for kind in ("train", "prefill", "decode"):
            assert partition.batch_logical(get_config(arch), kind) == \
                jax_partition.batch_logical(jax_config(arch), kind)
    with pytest.raises(ValueError):
        partition.batch_logical(get_config("starcoder2-7b"), "serve")


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(
    ["batch", "embed", "heads", "kv_heads", "ffn", "vocab", "experts",
     "ssm_heads", "lru", None, "seq", "head_dim", "kv_seq"]),
    min_size=1, max_size=5),
    st.lists(st.sampled_from([1, 2, 8, 16, 32, 36, 40, 64, 128, 512, 4096]),
             min_size=1, max_size=5),
    st.sampled_from(MESHES), st.booleans())
def test_spec_never_reuses_mesh_axes(logical, dims, mesh, serve):
    n = min(len(logical), len(dims))
    logical, dims = tuple(logical[:n]), tuple(dims[:n])
    shape, axes = mesh
    rules = partition.SERVE_RULES if serve else partition.DEFAULT_RULES
    spec = partition.spec_for(dims, logical, make_abstract_mesh(shape, axes),
                              rules)
    assert spec == tuple(jax_partition.spec_for(
        dims, logical, jax_abstract_mesh(shape, axes),
        jax_partition.SERVE_RULES if serve else jax_partition.DEFAULT_RULES))
    sizes = dict(zip(axes, shape))
    used = []
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        prod = 1
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            assert ax not in used, "mesh axis used twice"
            used.append(ax)
            prod *= sizes[ax]
        assert dims[i] % prod == 0, "divisibility violated"


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dry-run module. Importing it sets ``XLA_FLAGS`` to
    512 host devices for its own process: bring this process's backend up
    first (one device), and restore the variable after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    assert jax.device_count() == 1
    return dryrun


def _tpu_hw():
    """The reference's TPU entry, as the port's `Hardware`."""
    from repro.core.roofline import TPU_V5E
    keep = ("name", "peak_flops", "hbm_bw", "ici_bw", "hbm_gib")
    return Hardware(**{k: getattr(TPU_V5E, k) for k in keep}), TPU_V5E


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_plan_cell_matches_reference(jax_dryrun, arch):
    hw, jhw = _tpu_hw()
    for d, m in SERVE_MESHES:
        assert dryrun.serve_plan_cell(arch, d, m, hw=hw) == \
            jax_dryrun.serve_plan_cell(arch, d, m, hw=jhw), (arch, d, m)
    rec = dryrun.serve_plan_cell(arch, 2, 2)
    assert rec["hardware"] == "h100_sxm"


def test_serve_plan_main_writes_records(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--serve-plan", "--arch", "starcoder2-7b",
                     "--serve-meshes", "1x1,2x2", "--out", str(tmp_path)])
    assert e.value.code == 0
    recs = json.loads((tmp_path / "serve_plan.json").read_text())
    assert [c["mesh"] for c in recs["cells"]] == ["1x1", "2x2"]
    assert all(c["status"] == "ok" for c in recs["cells"])
    assert "starcoder2-7b" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="DxM"):
        dryrun.main(["--serve-plan", "--serve-meshes", "2by2",
                     "--out", str(tmp_path)])


def test_plan_param_bytes():
    """The counted weights of starcoder2-7b: the unsharded engine's, and a
    2x2 plan's (four shards, each with half the sharded leaves and a copy
    of the replicated ones)."""
    cfg = get_config("starcoder2-7b")
    one = ServePlan(make_abstract_mesh((1, 1), ("data", "model")))
    plan = ServePlan(make_abstract_mesh((2, 2), ("data", "model")))
    full = plan_param_bytes(cfg, one)
    assert full == sum(math.prod(ps.shape)
                       * (4 if ps.dtype == "float32" else 2)
                       for ps in flatten(model_spec(cfg)).values())
    assert 14.0e9 < full < 15.5e9
    assert 30.0e9 < plan_param_bytes(cfg, plan) < 32.5e9


def test_meshes():
    mesh = make_serve_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.axis_names == ("data", "model")
    assert mesh.axis_sizes == (2, 2) and mesh.devices.shape == (2, 2)
    one = make_serve_mesh(1, 1, devices=["cpu"])
    assert ServePlan.from_mesh(one) is None
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    eng = ServeEngine(smoke_config("starcoder2-7b"), mesh=one,
                      kv_pool=PagedKVPool(page_tokens=8))
    assert eng.plan is None and eng.device.type == "cpu"
    assert ServePlan.from_mesh(None) is None
    plan = ServePlan.from_mesh(mesh)
    assert (plan.dp, plan.tp) == (2, 2) and str(plan.device(1, 1)) == "cpu"
    host = make_host_mesh(devices=["cpu"] * 3)
    assert host.axis_names == ("data",) and host.axis_sizes == (3,)
    hp = ServePlan.from_mesh(host)
    assert (hp.dp, hp.tp) == (3, 1)
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_serve_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="model row"):
        ServePlan(make_serve_mesh(1, 3, devices=["cpu", "cpu", "meta"]))
    with pytest.raises(ValueError, match="abstract mesh"):
        ServePlan(make_abstract_mesh((2, 2), ("data", "model"))).device()


def test_more_cuda_devices_than_exist_raise():
    """Without an explicit device list a serve mesh takes CUDA devices, and
    asks for more than there are (none on this machine) raise."""
    import torch
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"have {n} CUDA devices"):
        make_serve_mesh(n + 1, 1)
    from repro_torch.configs import smoke_config as sc
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    with pytest.raises(ValueError, match="CUDA devices"):
        ServeEngine(sc("starcoder2-7b"), kv_pool=PagedKVPool(page_tokens=8),
                    mesh=make_serve_mesh(2, 2 + n))


def test_psum_orders_and_checks_devices():
    import torch
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]),
             torch.tensor([5.0, 6.0])]
    out = ServePlan.psum(parts)
    assert len(out) == 3 and all(o is out[0] for o in out)
    assert out[0].tolist() == [9.0, 12.0]
    assert ServePlan.psum(parts[:1]) == parts[:1]
    with pytest.raises(ValueError, match="share one device"):
        ServePlan.psum(parts + [torch.zeros(2, device="meta"),
                                torch.zeros(2, device="meta")])
