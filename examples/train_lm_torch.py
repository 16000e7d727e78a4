"""End-to-end training on the PyTorch/CUDA port: a dense LM trained with
the full stack (saturated tile kernels, the fused AdamW kernel, the
sharded data pipeline, async checkpoints) through a simulated host loss
at mid-run and its elastic recovery.

The twin of examples/train_lm.py, through
``repro_torch.launch.train.build_trainer``. It runs on the GPU unless
given ``--device cpu``, and stops with an error when there is no CUDA
device and no device is named.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
      [--device cpu] [--tiny]
"""
import argparse
import tempfile
import time

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import build_trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="30 steps of batch 4 x 64 tokens")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    steps = 30 if args.tiny else args.steps
    batch, seq = (4, 64) if args.tiny else (8, 256)
    cfg = get_smoke_config("minitron-4b")
    print(f"minitron-4b smoke config: {cfg.param_count() / 1e6:.2f}M params")
    with tempfile.TemporaryDirectory(prefix="repro_torch_example_") as ckpt:
        trainer = build_trainer(
            "minitron-4b", smoke=True, steps=steps, batch=batch, seq=seq,
            ckpt_dir=ckpt, lr=1e-3, device=args.device,
            inject={steps // 2: ("node_loss", 1)})   # fail mid-run, recover
        t0 = time.time()
        out = trainer.run()
    losses = out["losses"]
    print(f"steps={out['final_step']}  loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}  recoveries={out['recoveries']}  "
          f"wall={time.time() - t0:.0f}s")
    assert out["recoveries"] >= 1, "the injected failure was not recovered"
    assert losses[-1] < losses[0]
    print("loss decreased across a simulated node failure")


if __name__ == "__main__":
    main()
