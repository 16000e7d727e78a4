"""Fault tolerance, elastic scaling, straggler mitigation.

The port of :mod:`repro.runtime.ft`: ``ElasticTrainer``,
``FailureInjector``, ``TrainLoopConfig`` and ``StragglerPolicy``, with
the logic of the JAX module. Its description:

Design (1000+-node posture, simulated faithfully on one process):

* **Failure detection** — every step ends with a heartbeat check. In a
  real deployment this is the JAX distributed runtime noticing a missing
  host; here a :class:`FailureInjector` raises on scheduled steps, which
  exercises the identical recovery path.
* **Checkpoint/restart** — :class:`repro_torch.checkpoint.Checkpointer` commits
  atomically every ``ckpt_every`` steps; recovery restores the latest
  committed step and *replays data deterministically* from the step
  counter (the pipeline is (seed, step)-addressable, so no data state is
  checkpointed).
* **Elastic scaling** — on host loss the trainer shrinks the data axis
  (e.g. 16→8 shards), reshards the same checkpoint onto the smaller
  topology (restore is host-count agnostic), rebuilds the jitted step for
  the new mesh, and continues with the same global batch (more per-host
  rows) or a proportionally smaller one.
* **Straggler mitigation** — per-step deadline tracking with an EWMA of
  step time; a step exceeding ``straggler_factor ×`` the EWMA is logged
  and counted; after ``straggler_patience`` consecutive slow steps the
  trainer treats the host set as degraded and triggers the elastic path
  (in simulation: records the decision). Synchronous SGD makes "skip the
  slow host" equivalent to elastic re-sharding, which is what we do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from . import chaos


class FailureEvent(RuntimeError):
    def __init__(self, step: int, kind: str, lost_hosts: int = 1):
        super().__init__(f"simulated {kind} at step {step}")
        self.step = step
        self.kind = kind
        self.lost_hosts = lost_hosts


class FailureInjector:
    """Deterministic fault schedule: {step: (kind, lost_hosts)}.

    A thin front end over the shared chaos registry
    (:class:`repro_torch.runtime.chaos.ScheduledFaults`, site
    ``train_host_loss``): every fire lands in the same telemetry
    stream as the saturator chaos sites, and an active
    :class:`~repro_torch.runtime.chaos.FaultPlan` naming
    ``train_host_loss`` can inject host loss on top of the step
    schedule."""

    def __init__(self, schedule: Optional[Dict[int, Any]] = None):
        self._reg = chaos.ScheduledFaults("train_host_loss", schedule)

    @property
    def schedule(self) -> Dict[int, Any]:
        return self._reg._armed

    @property
    def fired(self) -> List[int]:
        return self._reg.fired

    def check(self, step: int):
        ev = self._reg.check(step)
        if ev is not None:
            kind, lost = ev if isinstance(ev, tuple) else (ev, 1)
            raise FailureEvent(step, kind, lost)
        if chaos.chaos_point("train_host_loss", kernel=""):
            raise FailureEvent(step, "chaos_host_loss", 1)


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 3.0          # slow if step_time > factor × EWMA
    patience: int = 3            # consecutive slow steps before action
    ewma: float = 0.1


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "repro_torch_ckpt"
    keep: int = 3
    min_shards: int = 1
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    # Simulate the full host-process restart on recovery: drop every
    # in-process tile op (get_tile_op.cache_clear) so the rebuilt step
    # re-saturates — exactly what a replacement host does. The
    # persistent saturation cache + verify settings survive because
    # _recover re-applies the snapshot taken at __init__.
    simulate_host_restart: bool = False


class ElasticTrainer:
    """Synchronous data-parallel training loop with recovery.

    ``build_step(num_shards)`` returns (step_fn, pipeline) for the current
    topology — rebuilt after elastic events. The loop owns (params,
    opt_state), tensors on the model's device.
    """

    def __init__(self, cfg: TrainLoopConfig, build_step: Callable,
                 params, opt_state, *, num_shards: int,
                 injector: Optional[FailureInjector] = None,
                 checkpointer=None):
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.kernels import ops as _ops
        self.cfg = cfg
        self.build_step = build_step
        self.params = params
        self.opt_state = opt_state
        self.num_shards = num_shards
        self.injector = injector or FailureInjector()
        self.ckpt = checkpointer or Checkpointer(cfg.ckpt_dir, keep=cfg.keep)
        # Snapshot the process-global saturation settings so recovery can
        # restore them: a simulated host loss must come back with the
        # same persistent cache + verify level the run started with.
        self._sat_cache = _ops.current_saturation_cache()
        self._sat_verify = _ops.current_saturation_verify()
        self.log: List[Dict[str, Any]] = []
        self.losses: List[float] = []
        self.step = 0
        self._ewma_time: Optional[float] = None
        self._slow_streak = 0
        self.recoveries = 0
        self.elastic_events: List[Dict[str, Any]] = []

    # -- main loop -----------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        step_fn, pipeline = self.build_step(self.num_shards)
        while self.step < self.cfg.total_steps:
            try:
                t0 = time.perf_counter()
                self.injector.check(self.step)
                batch = pipeline.batch_at(self.step)
                self.params, self.opt_state, loss = step_fn(
                    self.params, self.opt_state, batch)
                dt = time.perf_counter() - t0
                self._track_straggler(dt)
                self.losses.append(float(loss))
                if (self.step + 1) % self.cfg.ckpt_every == 0:
                    self._checkpoint()
                self.step += 1
            except FailureEvent as ev:
                step_fn, pipeline = self._recover(ev)
        self.ckpt.wait()
        self._checkpoint(sync=True)
        return {"losses": self.losses, "recoveries": self.recoveries,
                "elastic_events": self.elastic_events,
                "final_step": self.step,
                "straggler_flags": [e for e in self.log
                                    if e.get("straggler")]}

    # -- recovery -------------------------------------------------------------------
    def _recover(self, ev: FailureEvent):
        from repro_torch.core.telemetry import telemetry
        from repro_torch.kernels import ops as _ops
        from repro_torch.kernels.tile_programs import get_tile_op
        self.recoveries += 1
        new_shards = max(self.num_shards - ev.lost_hosts,
                         self.cfg.min_shards)
        self.elastic_events.append(
            {"step": ev.step, "kind": ev.kind,
             "shards": (self.num_shards, new_shards)})
        self.num_shards = new_shards
        if self.cfg.simulate_host_restart:
            get_tile_op.cache_clear()
        # Re-apply the saturation settings snapshotted at __init__: the
        # rebuilt step must replay from the same persistent cache (warm
        # restart) and keep the same verification level, even if the
        # simulated replacement host started from process defaults.
        _ops.set_saturation_cache(self._sat_cache)
        _ops.set_saturation_verify(self._sat_verify)
        telemetry().record_recovery(ev.step, ev.kind, shards=new_shards)
        # restore the last committed state; data replays deterministically
        self.ckpt.wait()
        restored_step = self.ckpt.latest_step()
        if restored_step is not None:
            (self.params, self.opt_state), extra = self.ckpt.restore(
                (self.params, self.opt_state))
            self.step = int(extra.get("step", restored_step))
            # drop loss history past the restore point (recomputed)
            self.losses = self.losses[:self.step]
        else:
            self.step = 0
            self.losses = []
        return self.build_step(self.num_shards)

    def _checkpoint(self, sync: bool = False):
        self.ckpt.save(self.step + 1, (self.params, self.opt_state),
                       extra={"step": self.step + 1},
                       async_=not sync)

    # -- stragglers ------------------------------------------------------------------
    def _track_straggler(self, dt: float):
        pol = self.cfg.straggler
        if self._ewma_time is None:
            self._ewma_time = dt
            return
        slow = dt > pol.factor * self._ewma_time
        self.log.append({"step": self.step, "dt": dt, "straggler": slow})
        if slow:
            self._slow_streak += 1
            if self._slow_streak >= pol.patience:
                self.elastic_events.append(
                    {"step": self.step, "kind": "straggler_degrade",
                     "shards": (self.num_shards, self.num_shards)})
                self._slow_streak = 0
        else:
            self._slow_streak = 0
            self._ewma_time = (1 - pol.ewma) * self._ewma_time \
                + pol.ewma * dt
