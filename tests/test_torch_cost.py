"""The port's dispatch-level cost counter (`repro_torch.core.hlo_cost`),
its roofline (`core/roofline.py`) and the kernels' `work` on the CPU:

- a 6-step Python loop of (matmul + tanh) counts 6 * 2 * 128^3 flops
  within 5%, as the reference's scan does (`test_system.py::
  test_hlo_cost_counts_scan_trip`);
- a smoke train step counts the same on the CPU and on ``meta``: flops
  by class, both byte counts, transcendentals, collectives, kernel
  entries, ops and the peak of live bytes (the routes differ by design:
  "plain" on the CPU, the card's route on ``meta``);
- each of the six kernel wrappers under the counter yields one entry
  equal to its spec's `work`, on the CPU and on ``meta``; on ``meta`` it
  runs no plain version (``plain_calls`` unchanged) and returns outputs
  of the plain version's shapes and dtypes; with no counter the wrapper
  runs as before;
- the train step at the NAPEL corpus's cheapest point cut to 2 layers,
  counted on ``meta``, against JAX `analyze` of the reference's train
  step compiled for the CPU (one compile, module-scoped): flops within
  `JAX_FLOPS_RTOL` (3%; measured 0.15%: the port counts the flash
  forward's causal half where the reference's jnp attention computes
  the full square), while the same count without the remat rerun
  (8% under) or without the backward (71% under) falls outside;
- `roofline_terms` and `model_flops` equal the JAX module's for the same
  inputs and the reference's hardware entries (taken from the JAX
  package at run time).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import roofline
from repro_torch.core.hlo_cost import CostCounter, analyze, count
from repro_torch.kernels import count as kernel_count
from repro_torch.kernels import registry
from repro_torch.models import Model
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (init_state, make_loss_fn,
                                          make_train_step)

JAX_FLOPS_RTOL = 0.03
KERNELS = ("flash_attention", "paged_attention", "ssd_scan", "rglru_scan",
           "hdiff", "vadvc")
SAME_ON_EVERY_DEVICE = ("flops", "flops_by_class", "bytes_accessed",
                        "bytes_accessed_fused", "transcendentals",
                        "collectives", "warnings", "kernels", "ops",
                        "peak_live_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loop_of_matmuls_counts_every_trip():
    def loop(a, ws):
        for w in ws:
            a = torch.tanh(a @ w)
        return a

    for device in ("cpu", "meta"):
        a = torch.ones(128, 128, device=device)
        got = analyze(loop, a, [a] * 6)
        expect = 6 * (2 * 128 ** 3)
        assert abs(got["flops"] - expect) / expect < 0.05
        assert got["transcendentals"] == 6 * 128 * 128
        assert got["flops_by_class"] == {"fp32": expect + 6 * 128 * 128}


def test_bf16_products_count_at_the_tensor_core_class():
    a = torch.ones(64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.ones(32, 16, dtype=torch.bfloat16, device="meta")
    got = analyze(torch.mm, a, b)
    assert got["flops_by_class"] == {"bf16": 2 * 64 * 32 * 16}
    assert got["bytes_accessed"] == (64 * 32 + 32 * 16 + 64 * 16) * 2
    assert got["bytes_accessed_fused"] == got["bytes_accessed"]
    # views move nothing; elementwise ops fuse away
    got = analyze(lambda x: (x.t() * 2.0).sum(), a)
    assert got["bytes_accessed"] == 64 * 32 * 2 * 3 + 2
    assert got["bytes_accessed_fused"] == 64 * 32 * 2 + 2


def _smoke_step(arch, device):
    cfg = dataclasses.replace(smoke_config(arch), remat="full")
    model = Model(cfg, device=device, seed=0)
    oc = OptimizerConfig()
    step = make_train_step(model, oc)
    state = init_state(model, oc)
    tok = torch.zeros(2, 64, dtype=torch.int32, device=device)
    return step, state, {"tokens": tok, "labels": tok}


@pytest.mark.parametrize("arch", ["starcoder2-7b", "mamba2-780m",
                                  "recurrentgemma-2b", "qwen3-moe-30b-a3b"])
def test_smoke_train_step_counts_the_same_on_cpu_and_meta(arch):
    got = {d: analyze(*_smoke_step(arch, d)) for d in ("cpu", "meta")}
    for key in SAME_ON_EVERY_DEVICE:
        assert got["cpu"][key] == got["meta"][key], key
    routes = got["cpu"]["kernel_routes"]
    assert routes and all(set(r) == {"plain"} for r in routes.values())
    assert all("plain" not in r for r in got["meta"]["kernel_routes"].values())
    assert got["meta"]["peak_live_bytes"] > 0


def _kernel_args(name):
    spec = registry.get(name)
    inputs = spec.example_inputs(shape=dict(spec.cases[0].shape))
    return spec, [torch.from_numpy(v) for v in inputs.values()]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", KERNELS)
def test_each_wrapper_counts_one_entry_of_its_work(name, device):
    import importlib
    spec, cpu_args = _kernel_args(name)
    args = [a.to(device) for a in cpu_args]
    work = importlib.import_module(
        f"repro_torch.kernels.{name}.spec").work
    fn = spec.fn
    before = fn.plain_calls
    with CostCounter() as c:
        out = spec.fn(*args)
    assert len(c.entries) == 1
    entry = c.entries[0]
    want = work(*cpu_args)
    if name == "paged_attention" and device == "meta":
        # no lengths to read: every sequence at the table's capacity
        q, table, lengths = cpu_args[0], cpu_args[7], cpu_args[8]
        rows = q.shape[1] if q.ndim == 4 else 1
        cap = table.shape[1] * cpu_args[1].shape[-3] - (rows - 1)
        want = work(*cpu_args[:8], torch.full_like(lengths, cap))
        assert entry["lengths"] == "capacity"
    elif name == "paged_attention":
        assert entry["lengths"] == "read"
    assert entry["kernel"] == name
    assert entry["bytes"] == want["bytes"] > 0
    assert entry["flops"] == want["flops"]
    summary = c.summary()
    assert summary["ops"] == 0                      # the body is hidden
    assert summary["bytes_accessed"] == entry["bytes"]
    assert summary["flops"] == sum(entry["flops"].values())
    plain = spec.ref_fn(*cpu_args)
    outs = out if isinstance(out, tuple) else (out,)
    plains = plain if isinstance(plain, tuple) else (plain,)
    assert [(o.shape, o.dtype, o.device.type) for o in outs] == \
        [(p.shape, p.dtype, device) for p in plains]
    if device == "meta":
        assert fn.plain_calls == before
        assert entry["route"] != "plain"
    else:
        assert fn.plain_calls == before + 1
        assert entry["route"] == "plain"
        for o, p in zip(outs, plains):
            torch.testing.assert_close(o, p, atol=0, rtol=0)
    # without a counter the wrapper runs as it did
    assert kernel_count.active() is None
    if device == "cpu":
        again = spec.fn(*args)
        for o, p in zip(again if isinstance(again, tuple) else (again,),
                        plains):
            torch.testing.assert_close(o, p, atol=0, rtol=0)
        assert fn.plain_calls == before + 2


def test_counter_leaves_no_active_counter_behind_an_exception():
    with pytest.raises(RuntimeError):
        with CostCounter():
            raise RuntimeError("boom")
    assert kernel_count.active() is None


@pytest.mark.parametrize("sq,skv,causal,window", [
    (10, 12, True, 0), (12, 10, True, 0), (10, 12, False, 0),
    (300, 300, True, 64), (7, 7, True, 100), (50, 80, False, 8)])
def test_visible_pairs_closed_form_equals_the_loop(sq, skv, causal, window):
    from repro_torch.kernels.flash_attention.spec import visible_pairs
    loop = sum((min(i + 1, skv) if causal else skv)
               - (max(0, i - window + 1) if window else 0)
               for i in range(sq))
    assert visible_pairs(sq, skv, causal, window) == loop


# -- the reference's train step, compiled once -----------------------------
@pytest.fixture(scope="module")
def cheapest_point():
    from repro_torch.core.napel.corpus import DOE_PARAMS
    from repro_torch.core.napel.doe import central_composite
    return min(central_composite(DOE_PARAMS),
               key=lambda p: p["num_layers"] * p["d_model"] ** 2
               * p["seq"] * p["batch"])


@pytest.fixture(scope="module")
def jax_train_flops(cheapest_point):
    import jax

    from repro.core.hlo_cost import analyze as jax_analyze
    from repro.core.napel.corpus import make_cfg
    from repro.models import Model as JaxModel
    from repro.train.optimizer import OptimizerConfig as JaxOC
    from repro.train.train_step import (abstract_batch, abstract_state,
                                        make_train_step as jax_step)
    p = cheapest_point
    model = JaxModel(dataclasses.replace(make_cfg(p), num_layers=2))
    oc = JaxOC()
    kwargs = {"state": abstract_state(model, oc, None),
              "batch": abstract_batch(model, p["seq"], p["batch"], None,
                                      "train")}
    compiled = jax.jit(jax_step(model, oc, mesh=None),
                       donate_argnames=("state",)).lower(**kwargs).compile()
    return jax_analyze(compiled.as_text())["flops"]


def _port_count(p, remat="full", backward=True):
    from repro_torch.core.napel.corpus import make_cfg
    from repro_torch.launch.dryrun import abstract_batch
    cfg = dataclasses.replace(make_cfg(p), num_layers=2, remat=remat)
    model = Model(cfg, device="meta")
    batch = abstract_batch(model, p["seq"], p["batch"], "train")
    if not backward:
        return analyze(make_loss_fn(model), batch)["flops"]
    oc = OptimizerConfig()
    return analyze(make_train_step(model, oc), init_state(model, oc),
                   batch)["flops"]


def test_train_step_flops_match_jax_analyze(cheapest_point, jax_train_flops):
    assert cheapest_point == {"num_layers": 4, "d_model": 512,
                              "seq": 1024, "batch": 32}
    got = _port_count(cheapest_point)
    assert abs(got / jax_train_flops - 1) < JAX_FLOPS_RTOL


@pytest.mark.parametrize("cut", ["no_remat", "no_backward"])
def test_a_count_missing_work_falls_outside(cheapest_point, jax_train_flops,
                                            cut):
    got = _port_count(cheapest_point, remat="none") if cut == "no_remat" \
        else _port_count(cheapest_point, backward=False)
    assert abs(got / jax_train_flops - 1) > JAX_FLOPS_RTOL


# -- roofline -----------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_roofline():
    from repro.core import roofline as jr
    return jr


@pytest.mark.parametrize("hw_name", ["tpu_v5e", "tpu_v4", "tpu_v5p",
                                     "trainium2"])
def test_roofline_terms_equal_the_reference(jax_roofline, hw_name):
    ref_hw = jax_roofline.HARDWARE[hw_name]
    hw = roofline.Hardware(**ref_hw.as_dict())
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c = 10.0 ** rng.uniform(8, 17, size=3)
        assert roofline.roofline_terms(f, b, c, hw) == \
            jax_roofline.roofline_terms(f, b, c, ref_hw)
    assert roofline.roofline_terms(0.0, 0.0, 0.0, hw) == \
        jax_roofline.roofline_terms(0.0, 0.0, 0.0, ref_hw)


def test_model_flops_equal_the_reference(jax_roofline):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_config
    from repro_torch.configs import list_archs
    for arch in list_archs():
        for name in SHAPES:
            for chips in (1, 256):
                assert roofline.model_flops(
                    get_config(arch), SHAPES[name], chips) == \
                    jax_roofline.model_flops(jax_config(arch),
                                             JSHAPES[name], chips)


def test_flop_classes_are_priced_at_their_peaks():
    hw = roofline.H100_SXM
    got = roofline.roofline_terms({"bf16": 989e12, "fp32": 67e12}, 0.0, 0.0,
                                  hw)
    assert got["compute_s"] == pytest.approx(2.0)
    assert roofline.roofline_terms(989e12, 0.0, 0.0, hw)["compute_s"] == 1.0
    assert roofline.DTYPE_BYTES[torch.bfloat16] == 2
    with pytest.raises(KeyError):
        hw.peak("int8")


def test_counted_roofline_of_a_full_width_step_on_meta():
    """starcoder2-7b's prefill at 32 layers, 1 x 600, counted on meta:
    the counted flops exceed the 2ND model flops by the attention and
    the head, and the flash kernel's 32 entries carry its work."""
    from repro_torch.serve.steps import make_prefill_step
    cfg = get_config("starcoder2-7b")
    model = Model(cfg, device="meta")
    tok = torch.empty(1, 600, dtype=torch.int32, device="meta")
    _, c = count(make_prefill_step(model), tok)
    s = c.summary()
    assert s["kernels"]["flash_attention"]["entries"] == 32
    assert s["kernel_routes"] == {"flash_attention": {"wgmma": 32}}
    mf = roofline.model_flops(cfg, SHAPES["prefill_32k"].__class__(
        "p", 600, 1, "prefill"), 1)
    assert 0.9 < mf / s["flops"] < 1.1
