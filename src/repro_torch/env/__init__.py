"""repro_torch.env — Gym-style scheduling environment + classic baselines
(the port's copy of ``repro.env``).

- ``env``       — :class:`ClusterSchedulingEnv`, a duck-typed Gymnasium
  (reset/step/observation/reward) wrapper over the event engine's
  co-routine mode (``repro_torch.sim.engine.event_stream``), plus the reward
  catalogue (:data:`REWARDS`) and ``run_policy`` for driving native
  ``Scheduler`` objects through an episode bitwise-identically to
  ``simulate_events``.
- ``baselines`` — the classic policy zoo (FCFS, SJF, SRTF with oracle
  or predicted durations, heterogeneity-blind max-min share), each a
  native ``repro_torch.core.schedulers.Scheduler`` usable in both engines
  and as an env policy.
- ``compare``   — the policy-comparison harness: one
  TTD/JCT/GRU/CRU/goodput/evictions quality table over a shared trace
  (JSON + text, ``python -m repro_torch.env.compare``).
"""
from repro_torch.env.baselines import (FCFSScheduler, MaxMinShareScheduler,
                                       SJFScheduler, SRTFScheduler)
from repro_torch.env.env import (REWARDS, ClusterSchedulingEnv, StepWindow,
                                 run_policy)

# compare is imported lazily (PEP 562) so `python -m
# repro_torch.env.compare` does not find the module pre-imported in
# sys.modules (runpy warning).  importlib, not `from repro_torch.env
# import compare`: that statement looks the name up on this package
# first, which would call __getattr__ again.  Once the submodule is
# imported, the package attribute ``compare`` is the module (the import
# system sets it), as in the JAX package.
_COMPARE_NAMES = frozenset({
    "BLIND_POLICIES", "DEFAULT_POLICIES", "POLICIES", "TABLE_SCHEMA",
    "compare", "render_table", "run_one", "validate_table",
})


def __getattr__(name):
    if name in _COMPARE_NAMES:
        import importlib
        return getattr(importlib.import_module(__name__ + ".compare"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BLIND_POLICIES",
    "ClusterSchedulingEnv",
    "DEFAULT_POLICIES",
    "FCFSScheduler",
    "MaxMinShareScheduler",
    "POLICIES",
    "REWARDS",
    "SJFScheduler",
    "SRTFScheduler",
    "StepWindow",
    "TABLE_SCHEMA",
    "compare",
    "render_table",
    "run_one",
    "run_policy",
    "validate_table",
]
