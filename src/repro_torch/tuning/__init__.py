"""Fleet tuning service (DESIGN.md §15), the port of the reference
package's ``tuning/`` — the layer between install-time and runtime
tuning.

One tuning brain for a fleet of serving hosts: engines persist their
registry miss logs, a ``harvest`` step dedupes them into a file-backed
job queue, builder/evaluator workers (MITuna's ``builder.py`` /
``evaluator.py`` split) claim jobs under leases, time the candidates on
the hand-written kernels with the install-time evaluator, and commit
winners through the registry's two-writer-safe flush-merge.  An
``export`` step compiles the merged registry into a read-only, versioned
**find-db** artifact that engines load at start, so engine start stays
lookup-only fleet-wide.

``repro_torch.tuning.worker`` is imported explicitly (it pulls the
measurement stack); the queue and find-db stay light.
"""

from repro_torch.tuning.find_db import (attach, export_find_db, find_db_path,
                                        read_find_db)
from repro_torch.tuning.queue import JobQueue, TuneJob, harvest, queue_path

__all__ = ["JobQueue", "TuneJob", "attach", "export_find_db",
           "find_db_path", "harvest", "queue_path", "read_find_db"]
