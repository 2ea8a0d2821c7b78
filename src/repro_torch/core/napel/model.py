"""NAPEL: performance & energy prediction for dry-run cells (thesis Ch. 5) —
the port of the JAX package's ``repro/core/napel/model.py``.

The 'slow cycle-accurate simulator' whose cost NAPEL amortizes is, here,
the port's dry run: the step counted op by op on ``meta`` tensors
(`launch.dryrun`, `core.hlo_cost`). Targets are the per-device roofline
inputs (log flops / log bytes / log collective bytes); step time and
energy derive from the hardware model (`core.roofline.Hardware`: its
peaks and its energy constants, `H100_SXM` by default, where the
reference hard-codes a TPU's). Headline evaluation = leave-one-arch-out:
predict an architecture never seen in training (thesis §5.3.3).

Flops are predicted as one total, as in the reference, so the step time
prices them at the bf16 peak whatever their rate class.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core.napel.features import (FEATURE_NAMES, analytic_costs,
                                             featurize)
from repro_torch.core.napel.forest import (RandomForest, mean_relative_error,
                                           tune_hyperparameters)
from repro_torch.core.roofline import H100_SXM, Hardware, roofline_terms


def energy_joules(flops, hbm_bytes, coll_bytes, hw: Hardware = H100_SXM
                  ) -> float:
    """Joules of a step from the entry's constants (pJ per flop, per HBM
    byte, per link byte; a constant of None counts 0)."""
    return (flops * (hw.pj_per_flop or 0.0)
            + hbm_bytes * (hw.pj_per_hbm_byte or 0.0)
            + coll_bytes * (hw.pj_per_link_byte or 0.0)) * 1e-12


TARGETS = ("log_flops", "log_bytes", "log_coll")


class _Const:
    def __init__(self, v: float):
        self.v = v

    def predict(self, x):
        return np.full(len(x), self.v)

    @property
    def feature_importances_(self):
        return np.zeros(1)


@dataclasses.dataclass
class CellRecord:
    arch: str
    shape: str
    mesh_shape: tuple
    flops: float
    bytes_: float
    coll: float

    def _cfg_shape(self):
        return get_config(self.arch), SHAPES[self.shape]

    def features(self):
        cfg, shape = self._cfg_shape()
        return featurize(cfg, shape, self.mesh_shape)

    def analytic(self):
        cfg, shape = self._cfg_shape()
        return analytic_costs(cfg, shape, self.mesh_shape)

    def targets(self):
        """log2 residual of measured costs over the analytic napkin model —
        a bounded, learnable target (the hybrid analytic+ML formulation)."""
        measured = np.maximum([self.flops, self.bytes_, self.coll], 1.0)
        return np.log2(measured) - np.log2(self.analytic())


def load_dryrun_records(dryrun_dir: Path) -> list[CellRecord]:
    """The port's dry-run records (`launch.dryrun`: mesh 1x1, baseline)
    as cells at mesh (1, 1)."""
    out = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") != "ok" or r.get("mesh") != "1x1" \
                or r.get("variant", "baseline") != "baseline":
            continue
        out.append(CellRecord(r["arch"], r["shape"], (1, 1),
                              r["cost"]["flops_per_device"],
                              r["cost"]["bytes_per_device"],
                              max(r["collectives"]["total_bytes"], 1.0)))
    return out


class Napel:
    def __init__(self, tune: bool = True, seed: int = 0):
        self.tune = tune
        self.seed = seed
        self.models: dict[str, RandomForest] = {}
        self.train_time_s = 0.0

    def fit(self, records: list[CellRecord]):
        t0 = time.time()
        x = np.stack([r.features() for r in records])
        ys = np.stack([r.targets() for r in records])
        self.fallback_mean = {}
        for i, name in enumerate(TARGETS):
            kw = dict(max_features=x.shape[1], min_samples_leaf=1,
                      n_trees=80, max_depth=12)
            if self.tune and len(records) >= 12:
                kw, _ = tune_hyperparameters(x, ys[:, i], seed=self.seed)
            # CV-select RF residual model vs. constant residual (the
            # analytic napkin alone can beat a small-sample forest)
            rf_err, const_err = self._cv_compare(x, ys[:, i], kw)
            if rf_err <= const_err:
                self.models[name] = RandomForest(seed=self.seed, **kw).fit(
                    x, ys[:, i])
            else:
                self.models[name] = _Const(float(np.mean(ys[:, i])))
        self.train_time_s = time.time() - t0
        return self

    def _cv_compare(self, x, y, kw, folds=3):
        rng = np.random.default_rng(self.seed)
        idx = rng.permutation(len(y))
        rf_errs, c_errs = [], []
        for f in range(folds):
            te = idx[f::folds]
            tr = np.setdiff1d(idx, te)
            if len(tr) < 4 or len(te) < 1:
                continue
            rf = RandomForest(seed=self.seed, **kw).fit(x[tr], y[tr])
            rf_errs.append(np.mean(np.abs(rf.predict(x[te]) - y[te])))
            c_errs.append(np.mean(np.abs(np.mean(y[tr]) - y[te])))
        return (float(np.mean(rf_errs)) if rf_errs else np.inf,
                float(np.mean(c_errs)) if c_errs else np.inf)

    def predict_raw(self, features: np.ndarray, analytic: np.ndarray) -> dict:
        f = features[None] if features.ndim == 1 else features
        a = analytic[None] if analytic.ndim == 1 else analytic
        return {name: a[:, i] * 2.0 ** self.models[name].predict(f)
                for i, name in enumerate(TARGETS)}

    def predict_cell(self, arch: str, shape_name: str, mesh_shape: tuple,
                     hw: Hardware = H100_SXM) -> dict:
        cfg = get_config(arch)
        feats = featurize(cfg, SHAPES[shape_name], mesh_shape)
        ana = analytic_costs(cfg, SHAPES[shape_name], mesh_shape)
        raw = self.predict_raw(feats, ana)
        flops = float(raw["log_flops"][0])
        nbytes = float(raw["log_bytes"][0])
        coll = float(raw["log_coll"][0])
        terms = roofline_terms(flops, nbytes, coll, hw)
        return {"flops": flops, "bytes": nbytes, "coll": coll,
                "step_time_s": terms["step_time_bound_s"],
                "energy_j": energy_joules(flops, nbytes, coll, hw),
                "roofline": terms}

    def importances(self) -> dict:
        return {name: dict(zip(FEATURE_NAMES,
                               np.round(m.feature_importances_, 4)))
                for name, m in self.models.items()}


def leave_one_arch_out(records: list[CellRecord], seed=0,
                       hw: Hardware = H100_SXM) -> dict:
    """Per-arch MRE for step-time and energy on a never-seen architecture,
    both priced on `hw`."""
    archs = sorted({r.arch for r in records})
    rows = {}
    for arch in archs:
        train = [r for r in records if r.arch != arch]
        test = [r for r in records if r.arch == arch]
        if not test or len(train) < 8:
            continue
        napel = Napel(tune=False, seed=seed).fit(train)
        pt, at, pe, ae = [], [], [], []
        for r in test:
            pred = napel.predict_cell(r.arch, r.shape, r.mesh_shape, hw)
            actual_t = roofline_terms(r.flops, r.bytes_, r.coll, hw)
            pt.append(pred["step_time_s"])
            at.append(actual_t["step_time_bound_s"])
            pe.append(pred["energy_j"])
            ae.append(energy_joules(r.flops, r.bytes_, r.coll, hw))
        rows[arch] = {"perf_mre": mean_relative_error(pt, at),
                      "energy_mre": mean_relative_error(pe, ae),
                      "n_test": len(test)}
    return rows
