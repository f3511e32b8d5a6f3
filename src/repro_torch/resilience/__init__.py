"""Resilience plane (DESIGN.md §16): failpoint injection + degradation.

The port of the reference package's ``resilience/``.  Two halves,
stdlib only, so every layer of the stack — registry, tuning queue,
workers, ``tsmm_dot``, serving front end — can import them without
cycles:

* :mod:`repro_torch.resilience.failpoints` — named fault-injection sites
  (``fp("registry.flush.before_replace")``) armed from the environment
  (``REPRO_TORCH_FAILPOINTS``) or programmatically; off by default.
* :mod:`repro_torch.resilience.degrade` — the degradation ladder
  bookkeeping: a :class:`DegradeStats` sink counting every demotion
  (planned CUDA kernel → its plain PyTorch version → ``torch.matmul``,
  find-db → local plans, flush → deferred) plus the circuit breaker that
  pins a fallback after K failures.  Surfaced by
  ``Engine.health_report()``.
"""

from repro_torch.resilience import degrade, failpoints  # noqa: F401
from repro_torch.resilience.degrade import DegradeStats  # noqa: F401
from repro_torch.resilience.failpoints import InjectedFault, fp  # noqa: F401
