"""The port's dry run (`repro_torch.launch.dryrun`), its report
(`core/report.py`), the op breakdown (`core/hlo_inspect.py`) and the
serving step functions on the CPU:

- a smoke cell of each kind (train, prefill, decode) of seven families is
  "ok" with positive counts and the record's keys, counted on ``meta``;
- one full-width cell (starcoder2-7b ``train_4k``) counts in seconds
  (under `FULL_CELL_S`), its flash entries 32 layers x 2 (remat);
- malformed mesh flags and unknown variants raise `SystemExit`, and a
  variant needs a mesh; the records go under experiments/dryrun_torch/
  and the corpus under experiments/napel_corpus_torch/, never the
  reference's directories;
- the report renders over written records; `variant_delta` gives {}
  without a variant's record;
- `top_bytes_ops` ranks rows whose bytes sum to the counter's
  ``bytes_accessed`` exactly (its top rows within it);
- ``--save-hlo`` writes the cell's op log beside its record (1x1 and a
  1x2 mesh), which `hlo_inspect` reads as it reads a live counter;
  without the flag the record is the same and no file is written; a
  cached record keeps its ``ops_path``;
- `make_prefill_step` / `make_decode_step` give the reference's tokens on
  the starcoder2-7b smoke config with shared weights (fp32, greedy:
  equal).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.core import hlo_inspect, report
from repro_torch.core.hlo_cost import count
from repro_torch.launch import dryrun

FULL_CELL_S = 30.0
SMOKE_SHAPES = {"train": InputShape("train_s", 32, 2, "train"),
                "prefill": InputShape("prefill_s", 32, 2, "prefill"),
                "decode": InputShape("decode_s", 48, 2, "decode")}
FAMILIES = ("starcoder2-7b", "mamba2-780m", "recurrentgemma-2b",
            "qwen3-moe-30b-a3b", "minicpm3-4b", "llama-3.2-vision-11b",
            "musicgen-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cell_of_each_kind_is_ok(arch, kind, tmp_path):
    cfg = dataclasses.replace(smoke_config(arch), remat="full")
    shape = SMOKE_SHAPES[kind]
    rec = dryrun.run_cell(arch, shape.name, out_dir=tmp_path, cfg=cfg,
                          shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "1x1" and rec["chips"] == 1
    assert rec["cost"]["flops_per_device"] > 0
    assert 0 < rec["cost"]["bytes_per_device"] \
        <= rec["cost"]["bytes_per_device_unfused"]
    mem = rec["memory"]
    assert mem["live_bytes_per_device"] == mem["argument_bytes"] + \
        mem["output_bytes"] + mem["temp_bytes"] > 0
    assert mem["fits_hbm"]
    assert rec["roofline"]["step_time_bound_s"] > 0
    assert rec["useful_flops_ratio"] > 0
    assert rec["collectives"]["total_count"] == 0
    on_disk = json.loads((tmp_path / f"{arch}__{shape.name}__1x1.json")
                         .read_text())
    assert on_disk["cost"] == rec["cost"]


def test_full_width_cell_counts_in_seconds(tmp_path):
    rec = dryrun.run_cell("starcoder2-7b", "train_4k", out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["count_s"] < FULL_CELL_S
    assert rec["kernels"]["flash_attention"]["entries"] == 64
    assert rec["kernel_routes"] == {"flash_attention": {"wgmma": 64}}
    # 6ND of the model's matmuls plus the remat forward, attention, head
    assert 0.6 < rec["useful_flops_ratio"] < 0.9
    assert not rec["memory"]["fits_hbm"]
    assert rec["roofline"]["bottleneck"] == "compute"
    # a second call reads the cached record
    assert dryrun.run_cell("starcoder2-7b", "train_4k",
                           out_dir=tmp_path) == rec


@pytest.mark.parametrize("argv,match", [
    (["--all", "--mesh", "16by16"], "DxM"),
    (["--all", "--mesh", "0x4"], "DxM"),
    (["--all", "--variant", "ssm_bf17"], "unknown variant"),
    (["--arch", "starcoder2-7b", "--shape", "train_4k", "--mesh", "2x2x2x2"],
     "DxM")])
def test_flags_that_need_a_mesh_raise(argv, match):
    """The mesh flags are the reference's and run (tests/test_torch_dryrun_
    mesh.py); a malformed mesh or an unknown variant raises before any
    cell is counted, and a variant on one device raises too."""
    with pytest.raises(SystemExit, match=match):
        dryrun.main(argv)
    with pytest.raises(SystemExit, match="--variant counts a plan"):
        dryrun.run_cell("starcoder2-7b", "train_4k", variant="no_remat")


def test_records_go_to_the_port_directories():
    from repro_torch.core.napel import corpus
    assert dryrun.OUT_DIR.parts[-2:] == ("experiments", "dryrun_torch")
    assert report.DRYRUN_DIR == dryrun.OUT_DIR
    assert corpus.CORPUS_DIR.parts[-2:] == ("experiments",
                                            "napel_corpus_torch")
    root = Path(__file__).resolve().parents[1]
    assert dryrun.OUT_DIR.parent == root / "experiments"
    with pytest.raises(SystemExit, match="DxM"):
        corpus.main(["--mesh", "eight"])


def test_report_renders(tmp_path):
    for arch in ("starcoder2-7b", "mamba2-780m"):
        for kind in ("train", "decode"):
            shape = SMOKE_SHAPES[kind]
            dryrun.run_cell(arch, shape.name, out_dir=tmp_path,
                            cfg=smoke_config(arch), shape=shape)
    (tmp_path / "broken__x__1x1.json").write_text(json.dumps(
        {"arch": "broken", "shape": "x", "mesh": "1x1", "status": "error"}))
    table = report.roofline_table(dryrun_dir=tmp_path)
    assert table.count("\n") == 2 + 3
    assert "| mamba2-780m | decode_s |" in table
    runs = report.dryrun_table(dryrun_dir=tmp_path)
    assert "flash_attention:2" in runs and "broken" not in runs
    assert len(report.load(dryrun_dir=tmp_path)) == 4
    assert report.variant_delta("starcoder2-7b", "train_s", "x",
                                dryrun_dir=tmp_path) == {}


def test_top_bytes_ops_sum_to_the_total():
    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"), remat="full")
    fn, kwargs, _, _ = dryrun.input_specs(
        "recurrentgemma-2b", "train_s", cfg=cfg, shape=SMOKE_SHAPES["train"])
    _, c = count(fn, **kwargs, inspect=True)
    total = c.summary()["bytes_accessed"]
    rows = hlo_inspect.top_bytes_ops(c, top=10 ** 9)
    assert sum(r["bytes"] for r in rows) == total
    top = hlo_inspect.top_bytes_ops(c, 10)
    assert len(top) == 10 and sum(r["bytes"] for r in top) <= total
    assert [r["bytes"] for r in top] == sorted((r["bytes"] for r in top),
                                               reverse=True)
    assert any(r["op"] == "kernel:rglru_scan" for r in rows)
    assert any(r["source"].startswith("models/") for r in rows)
    assert "bytes/dev" in hlo_inspect.top_bytes_report(c, 5)
    assert hlo_inspect.collective_breakdown(c) == []
    assert "bytes/dev" in hlo_inspect.dominant_ops_report(c)
    with pytest.raises(ValueError):
        hlo_inspect.top_bytes_ops(count(fn, **kwargs)[1])


def test_record_function_ranges_name_the_source():
    def step(x):
        with torch.profiler.record_function("outer"):
            y = x * 2
            with torch.profiler.record_function("inner"):
                y = y + 1
        return y.sum()

    _, c = count(step, torch.ones(8, device="meta"), inspect=True)
    sources = {r["op"]: r["source"] for r in hlo_inspect.top_bytes_ops(c)}
    assert sources["mul"] == "outer" and sources["add"] == "inner"


def test_serving_steps_match_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke
    from repro.models import Model as JaxModel
    from repro.serve.kvcache import pad_caches as jax_pad_caches
    from repro.serve.steps import make_decode_step as jax_decode
    from repro.serve.steps import make_prefill_step as jax_prefill
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.common import flatten, unflatten
    from repro_torch.models.transformer import Model, pad_caches
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    arch = "starcoder2-7b"
    jm = JaxModel(jax_smoke(arch))
    tree = unflatten(flatten(jax.tree.map(np.asarray,
                                          jm.init(jax.random.PRNGKey(0)))))
    jparams = jax.tree.map(jnp.asarray, tree)
    model = Model(smoke_config(arch), device="cpu",
                  state=params_from_numpy(smoke_config(arch), tree))
    tok = np.random.default_rng(0).integers(
        0, smoke_config(arch).vocab_size, (2, 9)).astype(np.int32)
    want, jcaches = jax_prefill(jm)(jparams, {"tokens": jnp.asarray(tok)})
    got, caches = make_prefill_step(model)(torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    jcaches = jax_pad_caches(jm, jcaches, 16, 9)
    caches = pad_caches(caches, 16, model.cfg)
    nxt = np.array(want)[:, None]
    want2, _ = jax_decode(jm)(jparams, jcaches, {"tokens": jnp.asarray(nxt)},
                              9)
    got2 = make_decode_step(model)(caches, torch.from_numpy(nxt), 9)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


@pytest.mark.parametrize("mesh", ["1x1", "1x2"])
def test_saved_op_log_reads_as_the_live_counter(mesh, tmp_path):
    """``save_hlo``: the cell's op log beside its record; each of
    `hlo_inspect`'s functions gives the same rows from the file (its
    path or its loaded dict) as from a live counter of the same step (on
    a mesh, the reported position's share)."""
    arch, shape = "starcoder2-7b", SMOKE_SHAPES["train"]
    cfg = smoke_config(arch)
    rec = dryrun.run_cell(arch, shape.name, out_dir=tmp_path, cfg=cfg,
                          shape=shape, mesh=mesh, save_hlo=True)
    assert rec["status"] == "ok", rec.get("traceback")
    path = Path(rec["ops_path"])
    assert path == tmp_path / f"{arch}__{shape.name}__{mesh}.ops.json"
    if mesh == "1x1":
        fn, kwargs, _, _ = dryrun.input_specs(arch, shape.name, cfg=cfg,
                                              shape=shape)
        _, c = count(fn, **kwargs, inspect=True)
        pos = None
    else:
        fn, _, _, _, _ = dryrun.plan_input_specs(arch, shape.name, (1, 2),
                                                 cfg=cfg, shape=shape)
        _, c = count(fn, inspect=True)
        pos = tuple(int(i) for i in rec["position"].split(","))
    log = json.loads(path.read_text())
    assert set(log) == {"position", "rows", "coll_rows", "kernels"}
    for src in (path, str(path), log):
        for fn_ in (hlo_inspect.top_bytes_ops,
                    hlo_inspect.collective_breakdown):
            assert fn_(src, 10 ** 9) == fn_(c, 10 ** 9, position=pos)
        assert hlo_inspect.top_bytes_report(src) == \
            hlo_inspect.top_bytes_report(c, position=pos)
        assert hlo_inspect.dominant_ops_report(src) == \
            hlo_inspect.dominant_ops_report(c, position=pos)
    rows = hlo_inspect.top_bytes_ops(path, 10 ** 9)
    assert sum(r["bytes"] for r in rows) == \
        rec["cost"]["bytes_per_device_unfused"]
    assert len(log["kernels"]) == \
        rec["kernels"]["flash_attention"]["entries"]
    routes = {}
    for k in log["kernels"]:
        routes.setdefault(k["kernel"], {}).setdefault(k["route"], 0)
        routes[k["kernel"]][k["route"]] += 1
    assert routes == rec["kernel_routes"]
    assert all(k["work"]["bytes"] > 0 for k in log["kernels"])
    colls = hlo_inspect.collective_breakdown(log, 10 ** 9)
    assert sum(r["count"] for r in colls) == \
        rec["collectives"]["total_count"]
    assert bool(colls) == (mesh != "1x1")


def test_save_hlo_flag_and_cached_record(tmp_path):
    """``--save-hlo`` on the command line writes the op log and
    ``ops_path``; without it the same cell writes the same record and no
    file; a cached record read back without ``--force`` keeps its
    ``ops_path``."""
    arch, shape = "recurrentgemma-2b", "decode_32k"
    plain, saved = tmp_path / "plain", tmp_path / "saved"
    for out, extra in ((plain, []), (saved, ["--save-hlo"])):
        with pytest.raises(SystemExit) as exit_:
            dryrun.main(["--arch", arch, "--shape", shape, "--out",
                         str(out)] + extra)
        assert exit_.value.code == 0
    name = f"{arch}__{shape}__1x1"
    assert sorted(p.name for p in plain.iterdir()) == [f"{name}.json"]
    assert sorted(p.name for p in saved.iterdir()) == \
        [f"{name}.json", f"{name}.ops.json"]
    rec = json.loads((saved / f"{name}.json").read_text())
    rec0 = json.loads((plain / f"{name}.json").read_text())
    assert rec["ops_path"] == str(saved / f"{name}.ops.json")
    assert set(rec) - set(rec0) == {"ops_path"}
    for key in ("cost", "memory", "kernels", "kernel_routes", "roofline"):
        assert rec[key] == rec0[key], key
    assert dryrun.run_cell(arch, shape, out_dir=saved) == rec
    log = json.loads(Path(rec["ops_path"]).read_text())
    assert sum(r["bytes"] for r in log["rows"]) == \
        rec["cost"]["bytes_per_device_unfused"]
