"""The fleet tuning service's throughput: misses resolved per minute.

    PYTHONPATH=src python -m repro_torch.launch.tuning_service
    PYTHONPATH=src python -m repro_torch.launch.tuning_service \
        --device cpu --workers 2

The port of the reference's ``benchmarks/tuning_service.py`` (which
stays as it is).  A grid of TSMM problems (skinny-A decode shapes and
tall-A prefill shapes, fp32, k = 4096) is missed on a fresh fleet
directory, harvested into one job each, and drained by ``tune_service
work``: once by one worker process, once by ``--workers`` processes,
each phase against its own fresh directory (its own measurement cache,
so the second phase cannot replay the first's records).

Rows: per phase the jobs per minute over the span from the first claim
to the last completion (read off the queue's own audit trail, so the
workers' interpreter and CUDA start-up is left out; the wall time with
it is printed beside), and the span speedup of the fleet.  Workers on
one card time their candidates on it at the same time, so their
timings contend and the speedup is bounded by what the card and the
host's cores leave each; the gate is that every job is resolved exactly
once — one ``done`` event in each job's history, and the workers'
ledgers covering every job with no overlap — and the tool raises
otherwise.  ``--json`` writes the rows to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2])

# skinny-A decode shapes and tall-A prefill shapes across a bucket ladder,
# all TSMM and heavy enough (k = 4096) that a job's build and measurement
# outweigh the queue's claim/lease protocol
GRID = ((2, 4096, 512), (4, 4096, 512), (8, 4096, 512),
        (512, 4096, 64), (1024, 4096, 64), (2048, 4096, 64),
        (1024, 4096, 128), (2048, 4096, 128), (4096, 4096, 128))


def env_for(root: Path) -> dict:
    """The fleet directory's environment: plan and measurement caches,
    miss log and queue under ``root``."""
    return dict(os.environ, PYTHONPATH=SRC,
                REPRO_TORCH_PLAN_CACHE=str(root / "plans.json"),
                REPRO_TORCH_MEASURE_CACHE=str(root / "meas.json"),
                REPRO_TORCH_MISS_LOG=str(root / "misses.json"),
                REPRO_TORCH_TUNE_QUEUE=str(root / "queue.json"))


def seed_fleet(root: Path, problems, device) -> int:
    """Miss every problem once on ``device``'s platform in a registry of
    ``root`` and harvest the miss log; returns the job count."""
    from repro_torch.core.plan import Problem
    from repro_torch.core.registry import Registry
    from repro_torch.tuning.queue import JobQueue, harvest

    reg = Registry(plan_path=root / "plans.json",
                   measure_path=root / "meas.json")
    for m, k, n in problems:
        reg.get(Problem(m, k, n, "float32").key(), device)
    reg.flush_misses(root / "misses.json")
    q = JobQueue(root / "queue.json")
    harvest(q, miss_path=root / "misses.json")
    return q.status()["total"]


def exactly_once(queue_file: Path, worker_lines: list) -> dict:
    """Raise unless every job of the queue is done with one ``done``
    event and the workers' ledgers cover every job once; returns the
    jobs."""
    jobs = json.loads(queue_file.read_text())["jobs"]
    bad = {k: j["state"] for k, j in jobs.items()
           if j["state"] != "done"
           or [e[0] for e in j["history"]].count("done") != 1}
    credited = sorted(r[0] for rep in worker_lines for r in rep["results"])
    if bad or credited != sorted(jobs):
        raise RuntimeError(f"fleet: jobs not resolved exactly once: states "
                           f"{bad}, credited {credited}, jobs {sorted(jobs)}")
    return jobs


def drain(root: Path, workers: int, iters: int, device: str,
          timeout: float) -> dict:
    """Run ``workers`` worker processes until the queue is dry; returns
    the phase's jobs, span, wall time and worker ledgers."""
    cmd = [sys.executable, "-m", "repro_torch.launch.tune_service", "work",
           "--workers", str(workers), "--device", device, "--iters",
           str(iters), "--warmup", "0", "--top-k", "2", "--stable", "1",
           "--build-k", "2"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env_for(root), capture_output=True,
                         text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = [json.loads(line[len("worker: "):])
             for line in res.stdout.splitlines()
             if line.startswith("worker: ")]
    if res.returncode != 0:
        raise RuntimeError(f"fleet drain failed (rc={res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    jobs = exactly_once(root / "queue.json", lines)
    times = [t for j in jobs.values() for ev, _, t in j["history"]
             if ev in ("claim", "done")]
    return {"jobs": len(jobs), "span_s": max(times) - min(times),
            "wall_s": wall, "workers": lines}


def run(*, workers: int = 2, iters: int = 2, device: str = "cuda",
        timeout: float = 900.0) -> list:
    phases = {}
    for n in (1, workers):
        with tempfile.TemporaryDirectory(prefix=f"fleet{n}-") as root:
            seeded = seed_fleet(Path(root), GRID, device)
            ph = drain(Path(root), n, iters, device, timeout)
        if ph["jobs"] != seeded:
            raise RuntimeError(f"fleet: {seeded} jobs seeded, {ph['jobs']} "
                               f"in the queue")
        phases[n] = ph
    rows = [{"name": f"{n}_worker_jobs_per_min",
             "value": ph["jobs"] * 60.0 / max(ph["span_s"], 1e-9),
             "note": f"{ph['jobs']} jobs, each done once; span "
                     f"{ph['span_s']:.6f} s, wall {ph['wall_s']:.6f} s "
                     f"with start-up"}
            for n, ph in phases.items()]
    one, fleet = phases[1], phases[workers]
    rows.append({"name": f"speedup_{workers}_workers",
                 "value": one["span_s"] / max(fleet["span_s"], 1e-9),
                 "note": f"span of 1 worker / span of {workers} (wall "
                         f"{one['wall_s'] / max(fleet['wall_s'], 1e-9):.3f}"
                         f"x; {os.cpu_count()} host cores)"})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=2,
                    help="timed calls per measured candidate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds each phase's workers may take")
    ap.add_argument("--json", default="", help="write the rows here")
    args = ap.parse_args(argv)
    from repro_torch.serve.engine import resolve_device
    device = resolve_device(args.device)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
            if device.type == "cuda" else "cpu")
    print(card)
    rows = run(workers=args.workers, iters=args.iters, device=args.device,
               timeout=args.timeout)
    for r in rows:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": card, "grid": GRID, "rows": rows}, f,
                      indent=1)
    return rows


if __name__ == "__main__":
    main()
