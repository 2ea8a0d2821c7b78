"""The dry run on a mesh (`launch.dryrun --mesh`, `--multi-pod`,
`--variant`) and the per-position counts it rests on, on the CPU:

- counts: for small plans of each layout (the starcoder2-7b smoke at 2x2;
  6 q / 2 kv heads at 1x4; 8 q / 2 kv heads at 2x4; minicpm3-4b at 2x2;
  mamba2-780m at 2x2; recurrentgemma-2b at 1x4; granite-moe-3b-a800m
  with 2 microbatches at 2x2; a prefill at 2x2; remat, whose segments
  must recompute whole for the positions to count alike; sequence
  parallelism),
  the train step (or prefill) run
  whole on the CPU under the cost counter attributes to every position
  exactly what a one-position count of that position on ``meta``
  (``count_positions``) counts: flops by class, bytes, fused bytes,
  kernel entries and collectives by kind and bytes; no op of the whole
  run mixes two positions' tensors;
- the seams record the reference's collective kinds: all-gather and
  reduce-scatter for the FSDP gathers, all-reduce for the TP sums, the
  replica sums, the loss and the norm;
- one full-width cell of each kind (train, prefill, decode) on the 16 x
  16 pod and one on the 2 x 16 x 16 multi-pod are "ok", with both
  positions' counts beside the device's and per-device bytes;
- a variant's record beside the baseline's: `report.variant_delta` has
  the reference's keys; the report renders both pods;
- NAPEL's corpus counts a point on a mesh with its collectives.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.core import report
from repro_torch.core.hlo_cost import MIXED, CostCounter
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_abstract_mesh, make_serve_mesh
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.sharding import ShardedTrainModel, TrainPlan
from repro_torch.train.train_step import init_state, make_train_step

OC = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=0.5)
SMOKE = {"train": InputShape("train_s", 16, 4, "train"),
         "prefill": InputShape("prefill_s", 16, 4, "prefill"),
         "decode": InputShape("decode_s", 32, 4, "decode")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, device, n=4, s=16, kind="train"):
    if device == "meta":
        b = {"tokens": torch.empty(n, s, dtype=torch.int32, device="meta")}
        if kind == "train":
            b["labels"] = torch.empty(n, s, dtype=torch.int32,
                                      device="meta")
        return b
    g = torch.Generator().manual_seed(0)
    t = torch.randint(0, cfg.vocab_size, (n, s + 1), generator=g,
                      dtype=torch.int32)
    b = {"tokens": t[:, :-1].contiguous()}
    if kind == "train":
        b["labels"] = t[:, 1:].contiguous()
    return b


def _summary(c, pos):
    s = c.position_summary(pos)
    return {"flops": s["flops_by_class"], "bytes": s["bytes_accessed"],
            "fused": s["bytes_accessed_fused"],
            "kernels": {k: v["entries"] for k, v in s["kernels"].items()},
            "collectives": {k: (v["count"], v["bytes"])
                            for k, v in s["collectives"].items()
                            if isinstance(v, dict) and v["count"]}}


def count(cfg, shape, positions=None, mb=1, kind="train", rules=None):
    """{position: its count} of one train step (or prefill) over a plan:
    run whole on the CPU, or only `positions` on meta; and the ops that
    mixed two positions."""
    if positions is None:
        plan = TrainPlan(make_serve_mesh(*shape,
                                         devices=["cpu"] * (shape[0]
                                                            * shape[1])),
                         cfg, rules)
        dev = "cpu"
    else:
        plan = TrainPlan(make_abstract_mesh(shape, ("data", "model")), cfg,
                         rules, count_positions=positions)
        dev = "meta"
    model = ShardedTrainModel(cfg, plan, seed=0)
    batch = _batch(cfg, dev, kind=kind)
    if kind == "train":
        state = init_state(model, OC)
        step = make_train_step(model, OC, num_microbatches=mb)
        with CostCounter() as c:
            step(state, batch)
    else:
        with torch.no_grad(), CostCounter() as c:
            for d in plan.rows():
                per = 4 // plan.dp
                model.run(d, {k: v[d * per:(d + 1) * per]
                              for k, v in batch.items()}, mode="prefill")
    mixed = c.by_position.get(MIXED)
    return {p: _summary(c, p) for p in plan.shards}, \
        (mixed.ops if mixed else 0)


CASES = [
    ("starcoder2-7b", {}, (2, 2), 1, "train"),
    ("starcoder2-7b", {"num_heads": 6, "num_kv_heads": 2}, (1, 4), 1,
     "train"),
    ("qwen3-moe-30b-a3b", {"num_heads": 8, "num_kv_heads": 2}, (2, 4), 1,
     "train"),
    ("minicpm3-4b", {}, (2, 2), 1, "train"),
    ("mamba2-780m", {}, (2, 2), 1, "train"),
    ("recurrentgemma-2b", {}, (1, 4), 1, "train"),
    ("granite-moe-3b-a800m", {}, (2, 2), 2, "train"),
    ("minicpm3-4b", {}, (2, 2), 1, "prefill"),
    ("starcoder2-7b", {"num_heads": 6, "num_kv_heads": 2, "remat": "full"},
     (1, 4), 1, "train"),
    ("starcoder2-7b", {}, (2, 2), 1, "train-sp"),
    ("recurrentgemma-2b", {}, (1, 4), 1, "train-sp"),
    ("granite-moe-3b-a800m", {}, (2, 2), 1, "prefill-sp"),
]


@pytest.mark.parametrize("arch,kw,shape,mb,kind", CASES,
                         ids=[f"{c[0]}-{c[2][0]}x{c[2][1]}-{c[4]}"
                              + ("-heads" if c[1] else "") for c in CASES])
def test_one_position_counts_equal_the_whole_run(arch, kw, shape, mb, kind):
    cfg = dataclasses.replace(smoke_config(arch), **kw)
    sp = None
    if kind.endswith("-sp"):
        from repro_torch.launch import variants
        kind, sp = kind[:-3], variants.apply("seq_parallel", cfg)[1]
    whole, mixed = count(cfg, shape, mb=mb, kind=kind, rules=sp)
    assert mixed == 0
    for pos, want in whole.items():
        got, _ = count(cfg, shape, [pos], mb=mb, kind=kind, rules=sp)
        assert got[pos] == want, pos
    # two positions counted together: each its own count
    both, _ = count(cfg, shape, [(0, 0), (0, 1)], mb=mb, kind=kind,
                    rules=sp)
    assert both == {p: whole[p] for p in both}
    kinds = set(whole[(0, 0)]["collectives"])
    if kind == "train":
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    if sp:
        assert {"all-gather", "reduce-scatter"} <= kinds
    # model shard 0 runs the embedding, head and loss as well
    assert sum(whole[(0, 0)]["flops"].values()) > \
        sum(whole[(0, 1)]["flops"].values())


@pytest.mark.parametrize("arch,shape,mesh", [
    ("mamba2-780m", "prefill_32k", "16x16"),
    ("codeqwen1.5-7b", "decode_32k", "16x16"),
    ("starcoder2-7b", "train_4k", "16x16"),
    ("recurrentgemma-2b", "decode_32k", "2x16x16")])
def test_full_width_pod_cells_are_ok(arch, shape, mesh, tmp_path):
    rec = dryrun.run_cell(arch, shape, out_dir=tmp_path, mesh=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "pod" + mesh
    assert rec["chips"] == (512 if mesh == "2x16x16" else 256)
    assert set(rec["positions"]) == {"0,0", "0,1"}
    assert rec["position"] in rec["positions"] and rec["position_note"]
    top = rec["positions"][rec["position"]]
    assert rec["roofline"] == top["roofline"]
    assert rec["roofline"]["step_time_bound_s"] >= max(
        p["roofline"]["step_time_bound_s"]
        for p in rec["positions"].values())
    mem = rec["memory"]
    assert mem["live_bytes_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"] > 0
    assert rec["collectives"]["total_count"] > 0
    assert rec["count_s"] > 0


def test_variant_delta_and_report(tmp_path):
    cfg = dataclasses.replace(smoke_config("starcoder2-7b"), remat="full")
    shape = SMOKE["train"]
    for variant in ("baseline", "no_remat", "seq_parallel"):
        rec = dryrun.run_cell("starcoder2-7b", shape.name, out_dir=tmp_path,
                              cfg=cfg, shape=shape, mesh="2x2",
                              variant=variant)
        assert rec["status"] == "ok", rec.get("traceback")
    # sequence parallelism: each sublayer's output reduce-scatters
    assert rec["collectives"]["reduce-scatter"]["count"] > \
        json.loads((tmp_path / "starcoder2-7b__train_s__2x2.json")
                   .read_text())["collectives"]["reduce-scatter"]["count"]
    assert (tmp_path / "starcoder2-7b__train_s__2x2__variant_no_remat.json"
            ).exists()
    d = report.variant_delta("starcoder2-7b", "train_s", "no_remat",
                             mesh="2x2", dryrun_dir=tmp_path)
    assert set(d) == {"variant", "compute_s", "memory_s", "collective_s",
                      "step_time_bound_s", "roofline_fraction", "mem_gib"}
    assert d["compute_s"]["after"] < d["compute_s"]["before"]
    assert report.variant_delta("starcoder2-7b", "train_s", "ssm_bf16",
                                mesh="2x2", dryrun_dir=tmp_path) == {}
    for name in ("pod16x16", "pod2x16x16"):
        (tmp_path / f"x__y__{name}.json").write_text(json.dumps(
            {**json.loads((tmp_path / "starcoder2-7b__train_s__2x2.json")
                          .read_text()), "arch": "x", "shape": "y",
             "mesh": name}))
    table = report.dryrun_table("pod16x16", dryrun_dir=tmp_path)
    assert table.count("\n") == 2 and "| x | y |" in table
    assert "| x | y |" in report.roofline_table("pod2x16x16",
                                                dryrun_dir=tmp_path)
    pods = report.pod_table(dryrun_dir=tmp_path)
    assert pods.count("\n") == 2 and "| x |" in pods and " / " in pods
    table = report.variants_table(["no_remat", "seq_parallel"], mesh="2x2",
                                  dryrun_dir=tmp_path)
    assert "| no_remat | 1 | 0 |" in table
    assert "| seq_parallel | 1 | 0 |" in table


def test_cli_runs_a_mesh_cell(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "codeqwen1.5-7b", "--shape", "decode_32k",
                     "--both-meshes", "--out", str(tmp_path)])
    assert e.value.code == 0
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["codeqwen1.5-7b__decode_32k__pod16x16.json",
                     "codeqwen1.5-7b__decode_32k__pod2x16x16.json"]
    assert "pod2x16x16" in capsys.readouterr().out


def test_corpus_point_on_a_mesh():
    from repro_torch.core.napel import corpus
    p = {"num_layers": 2, "d_model": 256, "seq": 64, "batch": 16}
    one = corpus.compile_and_measure(corpus.make_cfg(p),
                                     corpus.train_shape(p))
    two = corpus.compile_and_measure(corpus.make_cfg(p),
                                     corpus.train_shape(p), (2, 2))
    assert one["coll"] == 1.0 and two["coll"] > 1.0
    assert two["flops"] < one["flops"]
