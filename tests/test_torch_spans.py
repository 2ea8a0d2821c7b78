"""The port's spans (`repro_torch.core.spans`) on the CPU:

- `span` dispatches no ``profiler`` op, with a profiler running or not,
  and under one it opens an op-scope range, not a user annotation (the
  kind that leaves a mark on the device timeline);
- the cost counter's op log of a smoke decode step (a fused
  `ServeSession.step`) and of a smoke train step (mamba2) is the one
  taken with every span doing nothing, as before the spans; an unguarded
  range would change it (its sources);
- every span the port opens is named ``repro_torch.<what>`` by a
  constant, and no file of the port names the benchmark;
- under a CPU profiler one session step with a chunk fill and a decode
  row opens every ``repro_torch.serve.*`` span inside the caller's range,
  and one mamba2 train step opens forward, backward and optimizer once
  each, with the SSD scan's backward inside the backward;
- `chip_smoke.py`'s trace readers, on synthetic events, count no span's
  or range's mark on the device timeline as a device operation.
"""
import ast
import contextlib
import importlib.util
from types import SimpleNamespace
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.core import hlo_inspect, spans
from repro_torch.core.hlo_cost import CostCounter
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.scheduler import Request
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig

SERVE = ("admit", "control", "launch", "tokens", "pages", "stream")
TRAIN = ("forward", "backward", "optimizer")
PORT = Path(spans.__file__).resolve().parents[1]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Namespaces(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func.namespace)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("profiling", [False, True])
def test_a_span_opens_a_range_only_under_a_profiler(profiling):
    ctx = profile(activities=[ProfilerActivity.CPU]) if profiling \
        else contextlib.nullcontext()
    with ctx, _Namespaces() as mode:
        with spans.span("repro_torch.test"):
            torch.ones(4) + 1
    assert "profiler" not in mode.seen
    assert "aten" in mode.seen
    if profiling:
        opened = [e for e in ctx.profiler.kineto_results.events()
                  if e.name() == "repro_torch.test"]
        assert len(opened) == 1
        assert not opened[0].is_user_annotation()


def test_every_span_is_a_constant_name_of_the_port():
    names = set()
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "perfbench" not in text and "BENCHMARK.json" not in text, \
            path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Call) and \
                    getattr(node.func, "attr", None) == "span" and \
                    getattr(node.func.value, "id", None) == "spans":
                arg, = node.args
                assert isinstance(arg, ast.Constant), path
                names.add(arg.value)
    assert names == {*(f"repro_torch.serve.{s}" for s in SERVE),
                     *(f"repro_torch.train.{s}" for s in TRAIN),
                     "repro_torch.ssd_scan.backward"}


def _session_at_a_mixed_step():
    """A fused session whose next step holds a decode row and a chunk
    fill (4-token pages, the second prompt two chunks long)."""
    cfg = smoke_config("starcoder2-7b")
    eng = ServeEngine(cfg, kv_pool=PagedKVPool(page_tokens=4), device="cpu",
                      decode_mode="fused")
    sess = ServeSession(eng, capacity=32, max_active=2)
    rng = np.random.default_rng(0)
    sess.submit(Request(rng.integers(0, cfg.vocab_size, 5).astype(np.int32),
                        8))
    while not any(a is not None and not a.prefilling for a in sess._rows):
        sess.step()
    sess.submit(Request(rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                        8))
    return sess


def _train_step():
    """A smoke mamba2 train step and its state and batch on the CPU."""
    cfg = smoke_config("mamba2-780m")
    model = Model(cfg, device="cpu", seed=0)
    oc = OptimizerConfig()
    tok = torch.randint(0, cfg.vocab_size, (2, 33),
                        generator=torch.Generator().manual_seed(0))
    return (ts.make_train_step(model, oc), ts.init_state(model, oc),
            {"tokens": tok[:, :-1].int(), "labels": tok[:, 1:].int()})


def _op_log(kind):
    if kind == "decode":
        sess = _session_at_a_mixed_step()
        run = sess.step
    else:
        step, state, batch = _train_step()

        def run():
            step(state, batch)
    with CostCounter(inspect=True) as c:
        run()
    return hlo_inspect.op_log(c)


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_the_op_log_is_the_one_without_spans(kind, monkeypatch):
    got = _op_log(kind)
    monkeypatch.setattr(spans, "span",
                        lambda name: contextlib.nullcontext())
    assert got == _op_log(kind)
    # a dispatched range (`record_function`'s) would name the ops' sources,
    # so the comparison above can see one
    monkeypatch.setattr(spans, "span", record_function)
    unguarded = _op_log(kind)
    assert unguarded != got
    assert any(r["source"].startswith("repro_torch.")
               for r in unguarded["rows"])


def _spans(prof):
    """{name: [(start ns, end ns)]} of the ``repro_torch.`` and
    ``caller`` ranges of a finished CPU profile."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("repro_torch.", "caller")):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_a_mixed_serving_step_opens_every_serving_span_in_its_caller():
    sess = _session_at_a_mixed_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            events = sess.step()
    assert events
    got = _spans(prof)
    (c0, c1), = got.pop("caller")
    assert sorted(got) == sorted(f"repro_torch.serve.{s}" for s in SERVE)
    for name, ivs in got.items():
        assert all(c0 <= s <= e <= c1 for s, e in ivs), name
    # each of the step's phases once, in order; control also before the
    # step (the rows) and in the verify step (the drafts)
    once = [got[f"repro_torch.serve.{s}"] for s in SERVE if s != "control"]
    assert all(len(ivs) == 1 for ivs in once)
    starts = [ivs[0][0] for ivs in once]
    assert starts == sorted(starts)
    assert len(got["repro_torch.serve.control"]) == 3


def test_a_train_step_opens_forward_backward_and_optimizer_once_each():
    step, state, batch = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            step(state, batch)
    got = _spans(prof)
    (c0, c1), = got.pop("caller")
    phases = [got.pop(f"repro_torch.train.{s}") for s in TRAIN]
    assert all(len(ivs) == 1 for ivs in phases)
    (f0, f1), (b0, b1), (o0, o1) = (ivs[0] for ivs in phases)
    assert c0 <= f0 <= f1 <= b0 <= b1 <= o0 <= o1 <= c1
    ssd = got.pop("repro_torch.ssd_scan.backward")
    assert len(ssd) == smoke_config("mamba2-780m").num_layers
    assert all(b0 <= s <= e <= b1 for s, e in ssd)
    assert not got


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its trace readers run on any events)."""
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, ranges, op", [
    ("paged_attention_kernel", (), True),
    ("repro_torch.serve.launch", (), False),
    ("repro_torch.ssd_scan.backward", ("vjp",), False),
    ("vjp", ("vjp", "plain_recompute"), False),
    ("vjp", (), True),
])
def test_chip_smoke_device_op_leaves_out_range_marks(chip_smoke, name,
                                                     ranges, op):
    assert chip_smoke.device_op(name, ranges) is op


def _kineto(name, start, end, device):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                           end_ns=lambda: end, device_type=lambda: device)


def test_chip_smoke_device_events_drop_the_marks_of_spans(chip_smoke):
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_kineto("repro_torch.serve.launch", 0, 900, cpu),
              _kineto("repro_torch.serve.launch", 50, 800, cuda),
              _kineto("gemm", 100, 300, cuda),
              _kineto("repro_torch.serve.tokens", 300, 900, cuda),
              _kineto("copy", 400, 450, cuda)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = chip_smoke.device_events(prof)
    assert [g[0] for g in got] == ["gemm", "copy"]
    assert [g[1:] for g in got] == [pytest.approx((0.0, 0.2)),
                                    pytest.approx((0.3, 0.35))]


def test_chip_smoke_device_time_under_a_range_leaves_out_marks(chip_smoke):
    def ev(kernels, *children):
        return SimpleNamespace(
            kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels],
            cpu_children=list(children))
    inner = ev([("repro_torch.train.optimizer", 5.0), ("adam", 3.0)])
    plain = ev([("plain_recompute", 40.0), ("chunk", 20.0)], inner)
    top = ev([("repro_torch.ssd_scan.backward", 100.0), ("vjp_k", 10.0)],
             plain)
    assert chip_smoke._device_us_under(top, ("plain_recompute",)) == 33.0
    assert chip_smoke._device_us_under(top, ()) == 73.0
