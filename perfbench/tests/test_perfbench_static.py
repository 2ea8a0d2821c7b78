"""The benchmark's files and arithmetic, without running the program:
every name resolves, a new cell, configuration, mix or metric is a new
file and entry, the generators repeat for a seed, the readers' arithmetic
holds on synthetic traces, and nothing imports what it may not."""
from __future__ import annotations

import ast
import json
import re
import shutil
import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.lib import readers, spec, trace, work  # noqa: E402
from perfbench.traffic import closed_clients  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert len(spec.end_to_end(BENCH, w["name"])) >= 2
        assert spec.per_layer(BENCH, w["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    w = spec.cell(cell, BENCH)
    c = spec.config(w["config"])
    assert c["name"] == w["config"]
    spec.reference_module(c["reference"])
    mix = spec.mix(w["traffic"])
    assert hasattr(spec.traffic_module(mix["kind"]), "run")
    for m in spec.per_layer(BENCH, cell):
        assert callable(spec.metric_reader(m["name"]))
    cfg_entry = [x for x in BENCH["configs"] if x["name"] == w["config"]][0]
    assert (ROOT / cfg_entry["file"]).is_file()
    assert cfg_entry["reduced"] == c["reduced"]


def test_a_new_cell_config_mix_and_metric_are_files_and_entries(tmp_path,
                                                                 monkeypatch):
    """Copy the benchmark's folder, add one file of each kind and one
    entry each in BENCHMARK.json, edit nothing else: all resolve."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    c = spec.config("starcoder2-7b")
    c.update(name="starcoder2-7b-copy")
    (bench_dir / "configs" / "starcoder2-7b-copy.json").write_text(
        json.dumps(c))
    m = spec.mix("decode-c32")
    m.update(clients=8, max_active=8)
    (bench_dir / "mixes" / "decode-c8.json").write_text(json.dumps(m))
    (bench_dir / "metrics" / "steps_seen.serve.py").write_text(
        "def read(rec):\n    return float(len(rec['steps_ms']))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0],
                             "name": "starcoder2-7b-copy",
                             "file": "perfbench/configs/"
                                     "starcoder2-7b-copy.json"})
    bench["workloads"].append({"name": "copy.decode-c8",
                               "config": "starcoder2-7b-copy",
                               "traffic": "decode-c8", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_seen.serve", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "out_tok_s"})
    for e in bench["end_to_end"]:
        if "workloads" in e and e["name"] in ("out_tok_s",):
            e["workloads"].append("copy.decode-c8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    loaded = spec.benchmark(tmp_path)
    w = spec.cell("copy.decode-c8", loaded)
    assert spec.config(w["config"])["name"] == "starcoder2-7b-copy"
    assert spec.mix(w["traffic"])["clients"] == 8
    names = [x["name"] for x in spec.per_layer(loaded, "copy.decode-c8")]
    assert names == ["steps_seen.serve"]
    assert spec.metric_reader("steps_seen.serve")(
        {"steps_ms": [1.0, 2.0]}) == 2.0


def test_the_request_stream_repeats_for_a_seed_and_not_across_seeds():
    mix = spec.mix("decode-c32")

    def draw(seed):
        r = closed_clients.Requests(mix, 49152, seed)
        return r.warm() + [r.next() for _ in range(64)]

    a, b, c = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(2 ** 31 + 6)
    assert all((x[0] == y[0]).all() and x[1:] == y[1:] for x, y in zip(a, b))
    assert any(len(x[0]) != len(y[0]) or (x[0] != y[0]).any()
               for x, y in zip(a, c))
    # every seed offers the same work: the same sizes in the same order,
    # each block of 32 a permutation of the evenly spaced lengths
    assert [(len(x[0]), x[1]) for x in a] == [(len(x[0]), x[1]) for x in c]
    for lo in range(32, 96, 32):
        assert sorted(len(x[0]) for x in a[lo:lo + 32]) == \
            sorted(closed_clients._grid(64, 512, 32))


def test_shared_heads_come_in_their_weights_share():
    mix = spec.mix("prefix-c16")
    r = closed_clients.Requests(mix, 49152, 7)
    block = [r.next() for _ in range(mix["clients"])]
    heads = [tuple(x[0][:x[2]][:4]) for x in block]
    counts = sorted((heads.count(h) for h in set(heads)), reverse=True)
    assert counts == [round(w * mix["clients"])
                      for w in mix["shared"]["weights"]]
    assert all(x[2] == mix["shared"]["head_tokens"] for x in block)


def _trace(ops, ranges, window=10.0):
    return trace.Trace(ops, ranges, window, {})


def test_idle_share_is_the_window_outside_the_union_of_operations():
    ops = [("k", 0.0, 2.0, ()), ("k", 1.0, 3.0, ()), ("k", 6.0, 7.0, ())]
    rec = {"trace": _trace(ops, {})}
    assert readers.idle_share(rec) == pytest.approx(60.0)
    assert readers.idle_share({"trace": _trace([], {})}) is None


def test_kernels_per_step_and_roofline_read_their_ranges():
    step = ("bench.step",)
    pa = ("bench.kernel.paged_attention", "bench.step")
    ops = [("a", 0.0, 0.1, step), ("b", 0.2, 0.3, pa), ("c", 0.4, 0.5, pa),
           ("p", 0.5, 0.6, ("bench.probe", "bench.step")),
           ("d", 2.0, 2.1, ())]
    ranges = {"bench.step": [(0.0, 1.0), (1.0, 1.9)]}
    kind = "NVIDIA H100 80GB HBM3"
    rec = {"trace": _trace(ops, ranges), "kind": kind,
           "calls": {"paged_attention": [(0.0, 3.35e12 * 0.05)]}}
    assert readers.kernels_per(rec, "bench.step") == 1.5
    assert readers.kernels_per(rec, "bench.step", every_thread=True) == 2.0
    # 50 ms of least time over 200 ms of device time under the range
    assert readers.roofline(rec, "paged_attention") == pytest.approx(25.0)
    rec["kind"] = "cpu"
    assert readers.roofline(rec, "paged_attention") is None


def test_tails_and_rates_are_over_every_request_of_the_window():
    vals = list(range(1, 101))
    assert work.p95(vals) == statistics.quantiles(vals, n=100,
                                                  method="inclusive")[94]
    r1 = closed_clients.Rec([1] * 10, 3, 0)
    r1.times = [0.5, 1.5, 2.5]
    r2 = closed_clients.Rec([1] * 4, 2, 2)
    r2.times = [3.5, 20.0]
    c = spec.config("starcoder2-7b")
    # outputs in [1, 10]: r1's 2nd and 3rd, r2's 1st; prompts of requests
    # whose first token came in it: r2's two unshared tokens
    flops = closed_clients.window_flops(c, [r1, r2], 1.0, 10.0)
    assert flops == work.forward_flops(c, 5, 12 + 13 + 5 + 3 + 4)


def test_the_least_work_of_a_paged_attention_call():
    import torch
    q = torch.empty(2, 36, 128, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(10, 128, 4, 128, dtype=torch.bfloat16,
                       device="meta")
    flops, nbytes = work.paged_attention_work(q, pool, [100, 0], 1)
    assert flops == 4 * 36 * 128 * 100
    assert nbytes == 2 * 2 * 36 * 128 * 2 + 2 * 100 * 4 * 128 * 2


def test_ranges_name_the_innermost_open_range():
    r = trace.Ranges([("bench.window", 0, 100), ("bench.step", 10, 50),
                      ("bench.kernel.x", 20, 30), ("bench.step", 60, 90)])
    assert r.at(25) == ("bench.kernel.x", "bench.step", "bench.window")
    assert r.at(40) == ("bench.step", "bench.window")
    assert r.at(55) == ("bench.window",)
    assert r.at(150) == ()


class _Ev:
    def __init__(self, name, dev, start, end, corr, tid=1):
        self._v = (name, dev, start, end, corr, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_reduce_links_each_kernel_to_the_range_that_launched_it():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [_Ev("bench.window", cpu, 0, 1000, 0),
              _Ev("bench.step", cpu, 100, 400, 0),
              _Ev("cudaLaunchKernel", cpu, 150, 160, 7),
              _Ev("cudaLaunchKernel", cpu, 500, 510, 8),
              _Ev("bench.step", gpu, 100, 400, 0),
              _Ev("gemm", gpu, 200, 300, 7), _Ev("copy", gpu, 600, 700, 8)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    tr = trace.reduce(Prof)
    assert [(op[0], op[3]) for op in tr.ops] == [
        ("gemm", ("bench.step", "bench.window")), ("copy", ("bench.window",))]
    assert tr.busy_s == pytest.approx(200e-9)
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.gaps["bench.step"] == pytest.approx(200e-9)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    files = list((ROOT / "perfbench").rglob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".", 1)[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, f
    assert "repro_torch".split(".", 1)[0] != "repro"


def test_the_references_import_nothing_of_the_program():
    for f in (ROOT / "perfbench" / "reference").glob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(f)}
        assert not tops & {"repro_torch", "repro", "jax"}, f
