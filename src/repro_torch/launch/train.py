"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_4b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir build/ck

Runs ``train/loop.py`` on the card (``--device cuda``, the default; the
loop raises where there is none) or, asked, on the CPU.  The run resumes
from the latest checkpoint in ``--ckpt-dir`` when there is one.  The
reference's ``--tp`` / ``--mesh`` wait for training's sharding slice.
Prints the reference's summary line.
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.configs.base import ShapeSpec, get_config, get_reduced_config
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import LoopConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=LoopConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    report = run(
        model, shape,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=args.ckpt_dir),
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                  decay_steps=args.steps),
        device=args.device)
    print(f"ran {report.steps_run} steps; "
          f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}; "
          f"stragglers={len(report.straggler_steps)}; "
          f"resumed_from={report.resumed_from}")
    return report


if __name__ == "__main__":
    main()
