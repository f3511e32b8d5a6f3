"""Fleet tuning service CLI (DESIGN.md §15): harvest | work | export |
status.  The port of the reference's ``launch/tune_service.py``.

The multiprocess-on-one-box fleet, end to end:

    # engines served traffic without a background tuner (the fleet mode)
    # and flushed their registry misses to the persisted miss log; turn
    # the log into deduped, priority-ranked queue jobs:
    PYTHONPATH=src python -m repro_torch.launch.tune_service harvest

    # drain the queue with 2 builder/evaluator worker processes on the
    # card (--device cpu: the plain versions, on the CPU's jobs):
    PYTHONPATH=src python -m repro_torch.launch.tune_service work \\
        --workers 2

    # compile the merged registry into the read-only find-db artifact
    # (and bundle the built kernel libraries with a sha256 manifest):
    PYTHONPATH=src python -m repro_torch.launch.tune_service export \\
        --out build/fleet/find_db.json --programs build/fleet/kernels

    # fleet health: queue states, pending misses, artifact header
    PYTHONPATH=src python -m repro_torch.launch.tune_service status

Paths come from the environment (``REPRO_TORCH_TUNE_QUEUE``,
``REPRO_TORCH_MISS_LOG``, ``REPRO_TORCH_PLAN_CACHE``, ...) like the
registry's, so the whole fleet is configured by pointing every process
at one shared directory.

``work --workers N`` starts N fresh interpreters of this module (one
worker each, ``subprocess.Popen``: a process holding a CUDA context is
never forked), so claims exercise the real cross-process lock; a worker
that dies mid-lease is healed by lease expiry — the next claimer
requeues its job.  The workers share the card and the kernel build
directory (``kernels/cuda.py`` builds into a temporary file and renames
it), and their timings contend.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys

log = logging.getLogger(__name__)


def _queue(args):
    from repro_torch.tuning.queue import JobQueue
    return JobQueue(args.queue or None)


def cmd_harvest(args) -> int:
    from repro_torch.tuning.queue import harvest
    counts = harvest(_queue(args), miss_path=args.miss_log or None,
                     top_candidates=args.top_candidates,
                     expire_after_s=(args.expire_after
                                     if args.expire_after > 0 else None))
    print("harvest: " + json.dumps(counts))
    return 0


def _work_one(args) -> int:
    from repro_torch.tuning.worker import run_worker
    report = run_worker(_queue(args), max_jobs=args.max_jobs or None,
                        lease_s=args.lease_s, device=args.device,
                        build_k=args.build_k, top_k=args.top_k,
                        stable=args.stable, iters=args.iters,
                        warmup=args.warmup)
    print("worker: " + json.dumps(report.to_json()), flush=True)
    return 0 if report.failed == 0 else 2


def cmd_work(args) -> int:
    if args.workers <= 1:
        return _work_one(args)
    cmd = [sys.executable, "-m", "repro_torch.launch.tune_service"]
    if args.queue:
        cmd += ["--queue", args.queue]
    cmd += ["work", "--workers", "1", "--device", args.device,
            "--lease-s", str(args.lease_s), "--build-k", str(args.build_k),
            "--top-k", str(args.top_k), "--stable", str(args.stable),
            "--iters", str(args.iters), "--warmup", str(args.warmup)]
    if args.max_jobs:
        cmd += ["--max-jobs", str(args.max_jobs)]
    procs = [subprocess.Popen(cmd) for _ in range(args.workers)]
    try:
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    q = _queue(args)
    print("fleet: " + json.dumps({"workers": args.workers,
                                  "exit_codes": rcs, **q.status()}))
    return 0 if all(rc == 0 for rc in rcs) else 2


def cmd_export(args) -> int:
    from repro_torch.tuning.find_db import (export_find_db,
                                            export_program_bundle)
    header = export_find_db(args.out, platform=args.platform or None,
                            measured_only=args.measured_only)
    print("find-db: " + json.dumps(header))
    if args.programs:
        manifest = export_program_bundle(args.programs)
        print(f"kernel libraries: {len(manifest['files'])} bundled -> "
              f"{args.programs}")
    return 0


def cmd_status(args) -> int:
    from repro_torch.core import registry
    from repro_torch.tuning.find_db import find_db_path, read_header
    q = _queue(args)
    print("queue: " + json.dumps({"path": str(q.path()), **q.status()}))
    miss_path = registry.miss_log_path()
    pending = registry._read_json(miss_path) or {}
    print(f"miss log: {len(pending)} records pending harvest "
          f"({miss_path})")
    fdb = find_db_path()
    if fdb is not None and fdb.exists():
        print("find-db: " + json.dumps(read_header(fdb)))
    for j in q.jobs().values():
        print(f"  {j.state:8s} p{j.priority:<4d} a{j.attempts} "
              f"{j.job_id}" + (f" -> {j.result}" if j.result else "")
              + (f" [{j.worker}]" if j.worker else ""))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="fleet tuning service (DESIGN.md §15)")
    ap.add_argument("--queue", default="",
                    help="queue file (default REPRO_TORCH_TUNE_QUEUE or a "
                         "sibling of the plan cache)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    h = sub.add_parser("harvest", help="miss log -> deduped queue jobs")
    h.add_argument("--miss-log", default="",
                   help="miss file (default REPRO_TORCH_MISS_LOG)")
    h.add_argument("--top-candidates", type=int, default=16,
                   help="model-ranked grammar candidates per job payload")
    h.add_argument("--expire-after", type=float, default=0.0,
                   help="drop PENDING jobs whose problem has not been "
                        "seen in a miss log for this many seconds (0 = "
                        "never)")

    w = sub.add_parser("work", help="run builder/evaluator workers")
    w.add_argument("--workers", type=int, default=1)
    w.add_argument("--device", default="cuda",
                   help="the device the workers build and time on (and "
                        "whose platform's jobs they claim)")
    w.add_argument("--max-jobs", type=int, default=0,
                   help="jobs per worker (0 = until the queue is dry)")
    w.add_argument("--lease-s", type=float, default=120.0)
    w.add_argument("--build-k", type=int, default=8,
                   help="builder short-list depth (candidates launched)")
    w.add_argument("--top-k", type=int, default=4)
    w.add_argument("--stable", type=int, default=2)
    w.add_argument("--iters", type=int, default=3)
    w.add_argument("--warmup", type=int, default=1)

    e = sub.add_parser("export", help="registry -> read-only find-db")
    e.add_argument("--out", required=True)
    e.add_argument("--platform", default="",
                   help="restrict to one platform (default: all)")
    e.add_argument("--measured-only", action="store_true",
                   help="export only timed winners")
    e.add_argument("--programs", default="",
                   help="also bundle this checkout's built kernel "
                        "libraries into this directory with a sha256 "
                        "manifest")

    sub.add_parser("status", help="queue / miss-log / artifact health")

    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return {"harvest": cmd_harvest, "work": cmd_work,
            "export": cmd_export, "status": cmd_status}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
