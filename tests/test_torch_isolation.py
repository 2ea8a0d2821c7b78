"""The port stands alone: importing `repro_torch` and every one of its
modules loads no ``jax``, no ``ml_dtypes`` and nothing of the JAX package
``repro``, and ``chip_smoke.py`` imports none of them."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    expected = {m.name for m in pkgutil.walk_packages(
        [str(SRC / "repro_torch")], "repro_torch.")}
    assert expected <= set(result["modules"])
    for name in ("serve.engine", "serve.speculative", "serve.prefix_cache",
                 "kernels.paged_attention.paged_attention",
                 "kernels.flash_attention.flash_attention",
                 "kernels.flash_attention.ref",
                 "kernels.flash_attention.spec",
                 "kernels.ssd_scan.ssd_scan", "kernels.ssd_scan.ref",
                 "kernels.ssd_scan.spec",
                 "kernels.rglru_scan.rglru_scan", "kernels.rglru_scan.ref",
                 "kernels.rglru_scan.spec",
                 "models.ssm", "models.rglru", "serve.paged_state",
                 "configs.mamba2_780m", "configs.recurrentgemma_2b",
                 "configs.cosmo_stencil", "core.autotune", "core.precision",
                 "core.precision_search", "kernels.hdiff.hdiff",
                 "kernels.hdiff.ref", "kernels.hdiff.spec",
                 "kernels.vadvc.vadvc", "kernels.vadvc.ref",
                 "kernels.vadvc.spec", "launch.weather_stencil",
                 "serve.metrics", "serve.preemption", "serve.frontend",
                 "serve.traffic", "serve.scheduler", "serve.kvcache",
                 "launch.serve", "core.sibyl.env", "core.sibyl.traces",
                 "core.sibyl.policies", "core.sibyl.agent",
                 "serve.placement", "launch.sibyl_storage",
                 "kernels.api", "convert", "models.moe",
                 "configs.codeqwen15_7b", "configs.granite_moe_3b_a800m",
                 "configs.qwen3_moe_30b_a3b", "configs.minicpm3_4b",
                 "configs.llama32_vision_11b", "configs.musicgen_medium",
                 "data.pipeline", "train.optimizer", "train.grad_compression",
                 "train.train_step", "train.trainer",
                 "checkpoint.checkpointer", "ft.straggler", "ft.supervisor",
                 "launch.train", "launch.dryrun", "core.hlo_inspect",
                 "examples", "examples.serve_stream", "examples.serve_lm",
                 "examples.quickstart", "examples.train_100m"):
        assert f"repro_torch.{name}" in result["modules"]


def test_chip_smoke_imports_no_jax_and_nothing_of_repro():
    """Every import in ``chip_smoke.py``, at top level or inside a
    function, names neither ``jax`` (nor ``jaxlib``) nor ``repro``."""
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}
