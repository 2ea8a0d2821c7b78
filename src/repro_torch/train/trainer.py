"""Training loop: the train step + checkpoint/restart + straggler monitoring
+ the prefetching data pipeline — the port of the JAX package's
``repro/train/trainer.py``.

Runs on ``cuda`` unless the caller passes ``device="cpu"``. A run starts
from the latest checkpoint in ``job.checkpoint_dir`` when there is one
(params, optimizer state and the pipeline's step: a JAX run's checkpoint
too), else from the model's weights seeded with ``job.seed``.
``metrics_history`` has the reference's keys.

``mesh=`` (`launch.mesh.make_serve_mesh(d, m, devices=...)`) trains over
the mesh's FSDP x TP plan (`train.sharding`): the same weights, batches
and numbers as the unsharded trainer, each shard holding its slices of
the state. A mesh of one position is the unsharded trainer on that
position's device. Checkpoints hold logical (unsharded) leaves in the
reference's layout, so a run resumes on any plan: a 2x2 run's checkpoint
at 1x1, 1x2 or 2x1.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, TokenPipeline
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models.transformer import Model
from repro_torch.train.grad_compression import make_error_feedback_compressor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.sharding import (ShardedTrainModel, TrainPlan,
                                        logical_opt_state, shard_opt_state)
from repro_torch.train.train_step import (abstract_state, init_state,
                                          make_train_step, state_from_tree,
                                          state_tree)

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainJobConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    async_checkpoint: bool = True
    grad_compression: bool = False
    num_microbatches: int = 1
    seed: int = 0
    log_every: int = 10


def batch_to(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: ModelConfig, oc: OptimizerConfig,
                 job: TrainJobConfig, mesh=None, device="cuda",
                 failure_hook: Optional[Callable] = None):
        self.cfg = cfg
        self.oc = oc
        self.job = job
        self.mesh = mesh
        self.plan = TrainPlan.from_mesh(mesh, cfg)
        if self.plan is not None:
            self.model = ShardedTrainModel(cfg, self.plan, seed=job.seed)
            self.device = self.plan.device(0, 0)
        else:
            self.device = torch.device(
                device if mesh is None or not hasattr(mesh, "devices")
                else mesh.devices.flat[0])
            self.model = Model(cfg, device=self.device, seed=job.seed)
        self.failure_hook = failure_hook
        gt = (make_error_feedback_compressor(self.plan)
              if job.grad_compression else None)
        self._step_fn = make_train_step(self.model, oc,
                                        num_microbatches=job.num_microbatches,
                                        grad_transform=gt)
        self.ckpt = (Checkpointer(job.checkpoint_dir)
                     if job.checkpoint_dir else None)
        self.monitor = StragglerMonitor(n_hosts=1)
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------------
    def _init_or_restore(self):
        pipe = TokenPipeline(self.cfg, self.job.seq_len,
                             self.job.global_batch, seed=self.job.seed)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            tree, meta = self.ckpt.restore(
                state_tree(abstract_state(self.cfg, self.oc)),
                device="cpu" if self.plan is not None else self.device)
            params = self.model.train_params()
            state = {"params": params,
                     "opt": self._load(params, state_from_tree(tree))}
            start = meta["step"]
            pipe.restore(meta["extra"]["pipeline"])
            log.info("restored checkpoint at step %d", start)
        else:
            state = init_state(self.model, self.oc)
            start = 0
        return state, start, pipe

    @torch.no_grad()
    def _load(self, params, restored: dict):
        """Copy restored logical params into `params` (the model's
        tensors, or its shards' slices); return the optimizer state, laid
        out as the params are."""
        if self.plan is None:
            for name, p in params.items():
                p.copy_(restored["params"][name])
            return restored["opt"]
        plan = self.plan
        for name, full in restored["params"].items():
            for d, m in plan.shards:
                params[d][m][name].copy_(full[plan.index(name, d, m)])
        return shard_opt_state(plan, restored["opt"])

    def _logical(self, state: dict) -> dict:
        """The state as the checkpoint holds it: logical leaves."""
        if self.plan is None:
            return state_tree(state)
        plan = self.plan
        logical = {"params": plan.logical_tree(state["params"]),
                   "opt": logical_opt_state(plan, state["opt"])}
        if "grad_comp" in state:
            logical["grad_comp"] = plan.logical_tree(state["grad_comp"])
        return state_tree(logical)

    def run(self) -> dict:
        state, start, pipe = self._init_or_restore()
        device = self.device

        def batches():   # explicit step indexing — prefetch-safe & resumable
            for s in range(start, self.job.steps):
                yield batch_to(pipe.batch_at(s), device)

        pf = Prefetcher(batches())
        last_metrics = {}
        try:
            for step in range(start, self.job.steps):
                t0 = time.time()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = next(pf)
                state, metrics = self._step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                self.monitor.record(0, dt)
                metrics["step_time_s"] = dt
                metrics["step"] = step
                self.metrics_history.append(metrics)
                last_metrics = metrics
                if step % self.job.log_every == 0:
                    log.info("step %d loss %.4f (%.2fs)", step,
                             metrics["loss"], dt)
                pipe.step = step + 1
                if self.ckpt is not None and \
                        (step + 1) % self.job.checkpoint_every == 0:
                    self.ckpt.save(step + 1, self._logical(state),
                                   extra={"pipeline": pipe.state()},
                                   blocking=not self.job.async_checkpoint)
            if self.ckpt is not None:
                self.ckpt.save(self.job.steps, self._logical(state),
                               extra={"pipeline": pipe.state()},
                               blocking=True)
        finally:
            pf.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        return {"state": state, "final_metrics": last_metrics,
                "history": self.metrics_history,
                "stragglers": self.monitor.stragglers()}
