"""Training entry point: the elastic, fault-tolerant loop over an arch,
the port of :mod:`repro.launch.train`.

Runs on the GPU unless ``--device`` names another:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 8 --batch 4 --seq 64

The path is the JAX package's: ``build_trainer`` -> ``ElasticTrainer.run``
-> per step the model's ``loss`` (each layer rematerialised) -> its
gradient -> ``apply_updates`` (the global norm, the ``l2_clip`` op, the
``adamw`` op on every leaf), with async atomic checkpoints and recovery
from a simulated host loss (``--inject-failure-at``).

Every family trains: dense (minitron-4b, granite-8b, ...), vlm
(qwen2-vl-2b), ssm (mamba2-1.3b), hybrid (zamba2-2.7b), moe (dbrx-132b,
arctic-480b) and encdec (whisper-small, whose step adds the audio frames
as the JAX step does: :func:`encdec_frames`). ``--cache-dir``,
``--no-cache`` and ``--verify`` set the saturation cache and the static
verifier as in the serve entry point. ``--compress {none,bf16,int8,
int8_ef}`` compresses and decompresses the step's gradients before the
update, as the JAX step's gradient exchange does on one process
(:func:`repro_torch.parallel.compressed_grads`; ``int8_ef`` trains as
``int8``, since the JAX step discards the error-feedback state).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional

import torch

from repro_torch.cache import default_cache_dir
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import SaturatorConfig
from repro_torch.core.telemetry import telemetry
from repro_torch.kernels import ops
from repro_torch.data import DataConfig, ShardedTokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import get_model, resolve_device
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.parallel import MODES
from repro_torch.runtime.ft import (ElasticTrainer, FailureInjector,
                                    TrainLoopConfig)


def encdec_frames(cfg, batch: int, seq: int, device) -> torch.Tensor:
    """The stub audio frontend's frames of an encdec train step: (batch,
    seq, d_model) f32, standard normal from a generator seeded 0, the
    same every step, as the JAX step draws them from ``PRNGKey(0)`` (the
    two generators give different numbers)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((batch, seq, cfg.d_model), generator=gen,
                       device=device)


def _with_frames(train_step, cfg, device):
    """An encdec train step: ``train_step`` on the batch and the
    :func:`encdec_frames` of its tokens' shape."""
    def step(params, opt_state, batch):
        B, S = batch["tokens"].shape
        return train_step(params, opt_state, {
            **batch, "frames": encdec_frames(cfg, B, S, device)})
    return step


def build_trainer(arch: str, *, smoke: bool, steps: int, batch: int,
                  seq: int, ckpt_dir: str, compress: str = "none",
                  inject: Optional[dict] = None,
                  lr: float = 3e-4, num_shards: int = 1, seed: int = 0,
                  device=None, cache_dir=None,
                  verify: Optional[str] = None) -> ElasticTrainer:
    """The JAX ``build_trainer`` for the port: the model on ``device``
    (CUDA unless named; with no CUDA device and none named it raises),
    seeded weights, f32 AdamW moments, a warmup of a tenth of the steps,
    checkpoints every quarter of them, the gradients compressed as
    ``compress`` names (:func:`repro_torch.launch.steps.make_update`). An
    encdec step trains on :func:`encdec_frames` of the batch's shape.
    ``cache_dir`` (False: off) and ``verify``, when given, set the
    process-wide saturation cache and verification level of every tile
    op the step builds."""
    if cache_dir is not None:
        ops.set_saturation_cache(cache_dir)
    if verify is not None:
        ops.set_saturation_verify(verify)
    device = resolve_device(device)
    arch = ARCH_IDS.get(arch, arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = get_model(cfg, device=device)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                        total_steps=steps)
    params = model.init(seed)
    opt_state = init_opt_state(params, opt_cfg)
    train_step = make_train_step(model, opt_cfg, compress=compress)
    if cfg.family == "encdec":
        train_step = _with_frames(train_step, cfg, device)

    def build_step(n_shards: int):
        pipe = ShardedTokenPipeline(DataConfig(
            vocab=cfg.vocab, seq_len=seq, global_batch=batch,
            seed=seed, shard_id=0, num_shards=1))
        return train_step, pipe

    loop_cfg = TrainLoopConfig(total_steps=steps,
                               ckpt_every=max(steps // 4, 1),
                               ckpt_dir=ckpt_dir)
    return ElasticTrainer(loop_cfg, build_step, params, opt_state,
                          num_shards=num_shards,
                          injector=FailureInjector(inject))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b",
                    help=f"one of {sorted(ARCH_IDS)} (every family "
                         "trains)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", default="none", choices=list(MODES))
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "directory for this run)")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--cache-dir", default=str(default_cache_dir()),
                    help="persistent saturation cache directory "
                         "(tile-op choices + schedules reused across runs)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the on-disk saturation cache")
    ap.add_argument("--verify", default=None,
                    choices=["off", "cheap", "full"],
                    help="static verification level for every kernel "
                         "build (default: REPRO_VERIFY, else off)")
    args = ap.parse_args(argv)
    # one front door for the cache/verify side-channels: explicit arg >
    # CLI flag > env var (REPRO_SAT_CACHE / REPRO_VERIFY)
    sat = SaturatorConfig.from_env(flags=args)

    inject = {args.inject_failure_at: ("node_loss", 1)} \
        if args.inject_failure_at else None
    # a directory of this run's own: recovery restores the latest step it
    # finds there, so a directory shared between runs would restore
    # another run's state (and keep-K would delete its checkpoints)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    print(f"checkpoints: {ckpt_dir}")
    trainer = build_trainer(args.arch, smoke=args.smoke, steps=args.steps,
                            batch=args.batch, seq=args.seq,
                            ckpt_dir=ckpt_dir, lr=args.lr,
                            compress=args.compress,
                            inject=inject, device=args.device,
                            cache_dir=sat.cache_dir, verify=sat.verify)
    t0 = time.time()
    out = trainer.run()
    losses = out["losses"]
    print(f"arch={args.arch} steps={out['final_step']} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"recoveries={out['recoveries']} wall={time.time()-t0:.1f}s")
    from repro_torch.launch.serve import cache_line
    print(cache_line(telemetry().snapshot()))
    guard = telemetry().snapshot()["guard"]
    print(f"  guard: levels={guard['ladder_levels']} "
          f"degradations={sum(guard['degradations'].values())} "
          f"breaker={guard['breaker_events']} "
          f"runtime_fallbacks={sum(guard['runtime_fallbacks'].values())} "
          f"recoveries={guard['elastic_recoveries']}")
    assert losses[-1] < losses[0], "training did not reduce loss"
    return out


if __name__ == "__main__":
    main()
