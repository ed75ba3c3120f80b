"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 --batch 8 --seq 64 --ckpt-dir checkpoints/qwen

The flags of ``repro.launch.train`` (without ``--force-devices``: the port
runs on one device), plus ``--device`` (default ``cuda``; ``--device
cpu`` runs the plain PyTorch path). Batches are ``data.lm_data``'s stream
from seed 0, weights random from ``TrainerConfig.seed``. Run the same
command again after a kill to resume from the newest checkpoint.
"""
import argparse
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import batch_at_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    def batch_fn(step):
        return {"tokens": batch_at_step(0, step, global_batch=args.batch,
                                        seq_len=args.seq,
                                        vocab=cfg.vocab_size, device=device)}

    trainer = Trainer(
        cfg,
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, num_microbatches=args.micro,
                      peak_lr=args.lr),
        batch_fn, device=device)
    metrics = trainer.run()
    print(f"done: {metrics}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
