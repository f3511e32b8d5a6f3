"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_4b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir build/ck

Runs ``train/loop.py`` on the card (``--device cuda``, the default; the
loop raises where there is none) or, asked, on the CPU.  The run resumes
from the latest checkpoint in ``--ckpt-dir`` when there is one.

``--mesh`` trains sharded, one rank a process launched by torchrun, on
the largest (data, model) mesh the world fills with ``--tp``-wide model
lines (``train/loop.py::make_elastic_mesh``); FSDP from
``launch/specs.py::FSDP_MIN_PARAMS`` parameters up (``sharding_options``).
Each rank takes the card ``cuda:{local_rank % device_count}`` (gloo
where ranks share a card, ``launch/mesh.py``); rank 0 prints:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --reduced \\
        --device cpu --mesh --tp 2 --steps 2 --ckpt-dir build/ck_tp

Prints the reference's summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

from repro_torch.configs.base import ShapeSpec, get_config, get_reduced_config
from repro_torch.models.registry import build_model, param_count
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import LoopConfig, make_elastic_mesh, run


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
    ap.add_argument("--tp", type=int, default=1,
                    help="the model axis's width on --mesh")
    ap.add_argument("--mesh", action="store_true",
                    help="train sharded over the torchrun world")
    args = ap.parse_args(argv)

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg)
    mesh = opts = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.specs import sharding_options
        desc = make_elastic_mesh(int(os.environ.get("WORLD_SIZE", 1)),
                                 args.tp)
        mesh = make_mesh(tuple(desc.shape.values()), desc.axis_names,
                         device=args.device)
        opts = sharding_options(desc, param_count(model))
    with (open(os.devnull, "w") if mesh is not None and mesh.rank
          else contextlib.nullcontext(sys.stdout)) as out, \
            contextlib.redirect_stdout(out):
        try:
            logging.basicConfig(
                level=logging.INFO if mesh is None or not mesh.rank
                else logging.WARNING,
                format="%(asctime)s %(levelname)s %(message)s")
            if mesh is not None:
                print(f"mesh {dict(mesh.shape)} backend={mesh.backend} "
                      f"fsdp={opts.fsdp}")
            shape = ShapeSpec("cli", args.seq, args.batch, "train")
            report = run(
                model, shape,
                LoopConfig(total_steps=args.steps,
                           ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir),
                OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          decay_steps=args.steps),
                device=args.device, mesh=mesh, opts=opts)
            print(f"ran {report.steps_run} steps; "
                  f"loss {report.losses[0]:.4f} -> "
                  f"{report.losses[-1]:.4f}; "
                  f"stragglers={len(report.straggler_steps)}; "
                  f"resumed_from={report.resumed_from}")
        finally:
            if mesh is not None:
                mesh.close()
    return report


if __name__ == "__main__":
    main()
