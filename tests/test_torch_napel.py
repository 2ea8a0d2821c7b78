"""The port's NAPEL (``core/napel/*``) and LEAPER (``core/leaper/
transfer.py``) against the JAX package's on the same inputs, on the CPU.
Everything here is numpy on both sides, so the tolerance is none: equal to
the bit.

- the DoE samplers (`central_composite`, `latin_hypercube`), the forest
  (`RandomForest` predictions and importances, `tune_hyperparameters`),
  the baselines (`MLPRegressor`, `DecisionTree`) and
  `mean_relative_error`;
- `featurize` and `analytic_costs` for every arch x shape at meshes (1, 1)
  and (16, 16); the corpus's points and configs;
- `Napel.fit` / `predict_cell` / `leave_one_arch_out` and
  `energy_joules` on the same synthetic records, with the reference's
  `TPU_V5E` and its energy constants injected into the port's
  `Hardware` (the port states no TPU number);
- `platform_labels` and `evaluate_transfer` with the reference's
  platforms injected, on the synthetic cells of
  `test_data_driven.py::test_leaper_transfer_beats_scratch_on_synthetic`;
- the port's own: dry-run records load at mesh (1, 1), the h100 entries
  carry the card's fitted constants.
"""
import json

import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.core import roofline as jr
from repro.core.leaper import transfer as jt
from repro.core.napel import baselines as jb
from repro.core.napel import corpus as jcorpus
from repro.core.napel import doe as jdoe
from repro.core.napel import features as jf
from repro.core.napel import forest as jforest
from repro.core.napel import model as jm
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import roofline
from repro_torch.core.leaper import transfer as pt
from repro_torch.core.napel import baselines as pb
from repro_torch.core.napel import corpus as pcorpus
from repro_torch.core.napel import doe as pdoe
from repro_torch.core.napel import features as pf
from repro_torch.core.napel import forest as pforest
from repro_torch.core.napel import model as pm


def _tpu():
    """The reference's TPU v5e entry and energy constants, as the port's
    `Hardware`."""
    return roofline.Hardware(**jr.TPU_V5E.as_dict(),
                             pj_per_flop=jm.PJ_PER_FLOP,
                             pj_per_hbm_byte=jm.PJ_PER_HBM_BYTE,
                             pj_per_link_byte=jm.PJ_PER_ICI_BYTE)


def _platforms():
    return {name: pt.Platform(roofline.Hardware(**p.hw.as_dict()),
                              p.compute_eff_knee, p.mem_eff, p.coll_eff,
                              p.launch_overhead_s)
            for name, p in jt.PLATFORMS.items()}


def _xy(n=40, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * rng.normal(size=n)
    return x, y


# -- DoE, forest, baselines ---------------------------------------------------
def test_doe_samplers_equal_the_reference():
    assert pdoe.central_composite(pcorpus.DOE_PARAMS) == \
        jdoe.central_composite(jcorpus.DOE_PARAMS)
    for seed in (0, 3):
        for n in (5, 12):
            assert pdoe.latin_hypercube(pcorpus.DOE_PARAMS, n, seed) == \
                jdoe.latin_hypercube(jcorpus.DOE_PARAMS, n, seed)


@pytest.mark.parametrize("kw", [dict(n_trees=20, max_depth=6),
                                dict(n_trees=10, min_samples_leaf=1,
                                     max_features=6, seed=3)])
def test_random_forest_equals_the_reference(kw):
    x, y = _xy()
    xt, _ = _xy(seed=1)
    got = pforest.RandomForest(**kw).fit(x, y)
    want = jforest.RandomForest(**kw).fit(x, y)
    np.testing.assert_array_equal(got.predict(xt), want.predict(xt))
    np.testing.assert_array_equal(got.feature_importances_,
                                  want.feature_importances_)


def test_tune_hyperparameters_equals_the_reference():
    x, y = _xy(n=18)
    assert pforest.tune_hyperparameters(x, y, seed=1) == \
        jforest.tune_hyperparameters(x, y, seed=1)
    a, b = _xy(n=7, seed=4)[1], _xy(n=7, seed=5)[1]
    assert pforest.mean_relative_error(a, b) == \
        jforest.mean_relative_error(a, b)


def test_baselines_equal_the_reference():
    x, y = _xy()
    xt, _ = _xy(seed=2)
    np.testing.assert_array_equal(
        pb.MLPRegressor(epochs=60, seed=1).fit(x, y).predict(xt),
        jb.MLPRegressor(epochs=60, seed=1).fit(x, y).predict(xt))
    np.testing.assert_array_equal(
        pb.DecisionTree(max_depth=8).fit(x, y).predict(xt),
        jb.DecisionTree(max_depth=8).fit(x, y).predict(xt))


# -- features -----------------------------------------------------------------
@pytest.mark.parametrize("mesh", [(1, 1), (16, 16)])
def test_features_equal_the_reference_for_every_cell(mesh):
    assert pf.FEATURE_NAMES == jf.FEATURE_NAMES
    for arch in list_archs():
        for name in SHAPES:
            cfg, jcfg = get_config(arch), jax_config(arch)
            shape, jshape = SHAPES[name], JSHAPES[name]
            np.testing.assert_array_equal(
                pf.featurize(cfg, shape, mesh),
                jf.featurize(jcfg, jshape, mesh))
            np.testing.assert_array_equal(
                pf.analytic_costs(cfg, shape, mesh),
                jf.analytic_costs(jcfg, jshape, mesh))


def test_corpus_points_equal_the_reference():
    assert pcorpus.DOE_PARAMS == jcorpus.DOE_PARAMS
    assert pcorpus.TEST_POINTS == jcorpus.TEST_POINTS
    for tag, p in pcorpus.corpus_points():
        got, want = pcorpus.make_cfg(p), jcorpus.make_cfg(p)
        for field in ("name", "family", "num_layers", "d_model",
                      "num_heads", "num_kv_heads", "head_dim", "d_ff",
                      "vocab_size"):
            assert getattr(got, field) == getattr(want, field)
        assert got.param_count() == want.param_count()
        rec = {"params": p, "mesh": [1, 1]}
        np.testing.assert_array_equal(pcorpus.corpus_features(rec),
                                      jcorpus.corpus_features(rec))


# -- NAPEL --------------------------------------------------------------------
ARCHS = ("starcoder2-7b", "mamba2-780m", "qwen3-moe-30b-a3b")
MESHES = ((16, 16), (2, 16, 16))


def _records(module, archs=ARCHS, seed=0, meshes=MESHES):
    """Synthetic dry-run cells: the napkin costs of each (arch, shape,
    mesh) times a seeded factor in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    out = []
    for arch in archs:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            for mesh in meshes:
                a = jf.analytic_costs(jax_config(arch), JSHAPES[shape], mesh)
                f, b, c = a * 2.0 ** rng.uniform(-1, 1, 3)
                out.append(module.CellRecord(arch, shape, mesh, f, b, c))
    return out


def test_energy_joules_equals_the_reference():
    for f, b, c in ((1e15, 2e12, 3e9), (0.0, 1.0, 0.0)):
        assert pm.energy_joules(f, b, c, _tpu()) == jm.energy_joules(f, b, c)
    h100 = roofline.H100_SXM
    assert pm.energy_joules(1e12, 1e9, 1e9, h100) == \
        (1e12 * h100.pj_per_flop + 1e9 * h100.pj_per_hbm_byte) * 1e-12


def test_napel_fit_and_predict_equal_the_reference():
    got = pm.Napel(tune=False).fit(_records(pm, meshes=((16, 16),)))
    want = jm.Napel(tune=False).fit(_records(jm, meshes=((16, 16),)))
    assert [type(got.models[t]).__name__ for t in pm.TARGETS] == \
        [type(want.models[t]).__name__ for t in jm.TARGETS]
    for arch in ARCHS + ("llama3-405b",):
        for shape in ("train_4k", "decode_32k"):
            for mesh in MESHES + ((1, 1),):
                assert got.predict_cell(arch, shape, mesh, _tpu()) == \
                    want.predict_cell(arch, shape, mesh)
    assert got.importances() == want.importances()


def test_leave_one_arch_out_equals_the_reference():
    archs = ("starcoder2-7b", "mamba2-780m", "recurrentgemma-2b",
             "granite-moe-3b-a800m")
    one = ((16, 16),)
    got = pm.leave_one_arch_out(_records(pm, archs, 2, one), hw=_tpu())
    want = jm.leave_one_arch_out(_records(jm, archs, 2, one))
    assert got == want and set(got) == set(archs)


def test_load_dryrun_records_reads_the_port_records(tmp_path):
    base = {"status": "ok", "variant": "baseline",
            "cost": {"flops_per_device": 3e15, "bytes_per_device": 2e12},
            "collectives": {"total_bytes": 0}}
    for arch, shape, mesh, status in (
            ("starcoder2-7b", "train_4k", "1x1", "ok"),
            ("mamba2-780m", "long_500k", "1x1", "ok"),
            ("mamba2-780m", "decode_32k", "1x1", "error"),
            ("starcoder2-7b", "decode_32k", "pod16x16", "ok")):
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(
            {**base, "arch": arch, "shape": shape, "mesh": mesh,
             "status": status}))
    recs = pm.load_dryrun_records(tmp_path)
    assert [(r.arch, r.shape, r.mesh_shape) for r in recs] == [
        ("mamba2-780m", "long_500k", (1, 1)),
        ("starcoder2-7b", "train_4k", (1, 1))]
    assert recs[0].coll == 1.0 and recs[0].bytes_ == 2e12
    assert np.isfinite(recs[0].targets()).all()


# -- LEAPER -------------------------------------------------------------------
def _synthetic_cells(module):
    rng = np.random.default_rng(0)
    cells = []
    for _ in range(48):
        f = 10.0 ** rng.uniform(11, 16)
        b = f / 10 ** rng.uniform(1.0, 2.5)
        c = b / 10 ** rng.uniform(0.5, 2.0)
        cells.append(module.CellRecord("codeqwen1.5-7b", "train_4k",
                                       (16, 16), f, b, c))
    return cells, rng.standard_normal((48, 8))


def test_platform_labels_equal_the_reference():
    cells, _ = _synthetic_cells(pm)
    jcells, _ = _synthetic_cells(jm)
    for name in jt.PLATFORMS:
        np.testing.assert_array_equal(
            pt.platform_labels(name, cells, platforms=_platforms()),
            jt.platform_labels(name, jcells))


def test_evaluate_transfer_equals_the_reference():
    cells, feats = _synthetic_cells(pm)
    jcells, jfeats = _synthetic_cells(jm)
    got = pt.evaluate_transfer(cells, feats, "tpu_v4", shots_list=(5, 10),
                               seed=0, source="tpu_v5e",
                               platforms=_platforms())
    want = jt.evaluate_transfer(jcells, jfeats, "tpu_v4",
                                shots_list=(5, 10), seed=0)
    assert got == want
    for row in got.values():
        assert row["leaper_acc_pct"] > row["scratch_acc_pct"]


def test_h100_entries_carry_the_cards_constants():
    hw = roofline.H100_SXM
    assert (hw.peak_flops, hw.peak_flops_fp32, hw.hbm_bw) == \
        (989e12, 67e12, 3.35e12)
    assert 70 < hw.hbm_gib < 80
    assert hw.pj_per_flop > 0 and hw.pj_per_hbm_byte > 0
    assert hw.pj_per_link_byte is None
    p = pt.PLATFORMS["h100"]
    assert set(pt.PLATFORMS) == {"h100"} and p.hw is hw
    assert p.compute_eff_knee > 0 and 0 < p.mem_eff <= 1
    assert p.coll_eff == 1.0 and 0 < p.launch_overhead_s < 1e-3
    # a step the model prices: the largest of its terms and the overhead
    assert p.step_time(1e15, 1e12, 1.0) > 1e15 / hw.peak_flops
