"""DoE training corpus for NAPEL/LEAPER: a central-composite-design sweep
over a parametric dense-LM config space, each point's train step counted
(the 'few simulator runs' of thesis §5.2.4) — the port of the JAX
package's ``repro/core/napel/corpus.py``.

    python -m repro_torch.core.napel.corpus [--out DIR] [--mesh 8x8]

The reference lowers and compiles each point's train step on a mesh
(default 8 x 8) and reads its HLO; the port counts it on ``meta``
tensors (`compile_and_measure`: the cost counter over one train step,
nothing allocated) — on a mesh, one device of the training plan
(`launch.dryrun.count_cell_mesh`: positions (0, 0) and (0, 1), the
longer step's), whose seams record the collectives: the collective
target is their operand bytes (``max(collective bytes, 1)``, as the
reference floors it; 1 at mesh 1x1, where no seam runs). The corpus's
heads are ``max(4, d // 128)``, which the model axis does not always
divide: those points run their attention whole on every model shard. The
count's wall time takes the compile time's place in ``compile_s``.
Records name their mesh and cache as JSON under
experiments/napel_corpus_torch/ (never the reference's
experiments/napel_corpus/); `load_corpus` reads them back.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.napel.doe import central_composite

CORPUS_DIR = Path(__file__).resolve().parents[4] / "experiments" / \
    "napel_corpus_torch"
MESH = (1, 1)

# 5-level DoE parameters (thesis Table 5.2 style)
DOE_PARAMS = {
    "num_layers": [2, 4, 8, 16, 24],
    "d_model": [256, 512, 1024, 2048, 3072],
    "seq": [512, 1024, 2048, 4096, 8192],
    "batch": [16, 32, 64, 128, 256],
}
TEST_POINTS = [  # thesis 'test' inputs: outside the DoE grid
    {"num_layers": 6, "d_model": 768, "seq": 1536, "batch": 48},
    {"num_layers": 12, "d_model": 1536, "seq": 3072, "batch": 96},
    {"num_layers": 20, "d_model": 2560, "seq": 6144, "batch": 24},
    {"num_layers": 10, "d_model": 1280, "seq": 2048, "batch": 192},
    {"num_layers": 14, "d_model": 896, "seq": 5120, "batch": 40},
    {"num_layers": 18, "d_model": 1792, "seq": 1024, "batch": 160},
]


def make_cfg(p: dict) -> ModelConfig:
    d = p["d_model"]
    heads = max(4, d // 128)
    return ModelConfig(
        name=f"doe_l{p['num_layers']}_d{d}_s{p['seq']}_b{p['batch']}",
        family="dense", num_layers=p["num_layers"], d_model=d,
        num_heads=heads, num_kv_heads=heads, head_dim=d // heads,
        d_ff=4 * d, vocab_size=32768)


def train_shape(p: dict) -> InputShape:
    return InputShape(f"train_{p['seq']}", p["seq"], p["batch"], "train")


def compile_and_measure(cfg: ModelConfig, shape: InputShape,
                        mesh=MESH) -> dict:
    """The train step of `cfg` at `shape` counted on ``meta``, at mesh (1,
    1) or per device of a (data, model) mesh: ``{"flops", "bytes"
    (fusion-aware), "coll", "compile_s" (the count's wall time)}`` plus
    the count's rate classes, the bytes eager PyTorch moves and the live
    bytes (arguments + peak)."""
    if tuple(mesh) != MESH:
        from repro_torch.launch.dryrun import count_cell_mesh
        t0 = time.perf_counter()
        rec = count_cell_mesh(cfg.name, shape.name, tuple(mesh), cfg=cfg,
                              shape=shape)
        return {"flops": rec["cost"]["flops_per_device"],
                "bytes": rec["cost"]["bytes_per_device"],
                "coll": max(rec["collectives"]["total_bytes"], 1.0),
                "compile_s": time.perf_counter() - t0,
                "flops_by_class": rec["cost"]["flops_by_class"],
                "bytes_unfused": rec["cost"]["bytes_per_device_unfused"],
                "live_bytes": rec["memory"]["live_bytes_per_device"],
                "position": rec["position"]}
    from repro_torch.core.hlo_cost import CostCounter
    from repro_torch.launch.dryrun import storage_bytes, abstract_batch
    from repro_torch.models import Model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_state, make_train_step
    model = Model(cfg, device="meta")
    oc = OptimizerConfig()
    fn = make_train_step(model, oc)
    state = init_state(model, oc)
    batch = abstract_batch(model, shape.seq_len, shape.global_batch, "train")
    args_b = storage_bytes((state, batch))
    t0 = time.perf_counter()
    with CostCounter() as c:
        fn(state, batch)
    wall = time.perf_counter() - t0
    tc = c.summary()
    return {"flops": tc["flops"], "bytes": tc["bytes_accessed_fused"],
            "coll": max(tc["collectives"]["total_bytes"], 1.0),
            "compile_s": wall, "flops_by_class": tc["flops_by_class"],
            "bytes_unfused": tc["bytes_accessed"],
            "live_bytes": args_b + tc["peak_live_bytes"]}


def corpus_points() -> list:
    """(tag, params) of every corpus point: the DoE's, then the test
    points."""
    return [("doe", p) for p in central_composite(DOE_PARAMS)] + \
        [("test", p) for p in TEST_POINTS]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(CORPUS_DIR))
    ap.add_argument("--mesh", default="8x8")
    args = ap.parse_args(argv)
    try:
        md, mm = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DxM, got {args.mesh!r}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for tag, p in corpus_points():
        cfg = make_cfg(p)
        path = out_dir / f"{tag}__{cfg.name}__{args.mesh}.json"
        if path.exists():
            continue
        t0 = time.time()
        try:
            rec = compile_and_measure(cfg, train_shape(p), (md, mm))
            rec.update(status="ok")
        except Exception as e:
            rec = {"status": "error", "error": str(e)[:500]}
        rec.update(tag=tag, params=p, mesh=[md, mm])
        path.write_text(json.dumps(rec))
        print(f"{tag} {cfg.name}: {rec.get('status')} "
              f"({time.time() - t0:.1f}s)", flush=True)


def load_corpus(out_dir=CORPUS_DIR) -> list[dict]:
    out = []
    for p in sorted(Path(out_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") == "ok":
            out.append(r)
    return out


def corpus_features(rec: dict) -> np.ndarray:
    from repro_torch.core.napel.features import featurize
    p = rec["params"]
    cfg = make_cfg(p)
    shape = InputShape("t", p["seq"], p["batch"], "train")
    return featurize(cfg, shape, tuple(rec["mesh"]))


if __name__ == "__main__":
    main()
