"""The port's simulation subsystem (the port's copy of ``repro.sim``).

Simulated time advances between *scheduling points*; what counts as a
scheduling point is the only difference between the two engines:

- **round mode** (``engine.simulate_rounds``): the fixed ``round_len``
  grid — the paper's §IV round-based model.  Steady rounds under a
  ``stable_when_idle`` scheduler are fast-forwarded in bulk.
- **event mode** (``engine.simulate_events``, driven over the co-routine
  ``engine.event_stream``): job arrivals, *predicted completions*, fault
  events and (for schedulers that rotate allocations every round) a
  ``round_len`` re-schedule quantum.

Module map: ``events`` (the ``EventQueue``), ``engine`` (both engines),
``metrics`` (records and results), ``adapters`` (the
``CountingScheduler`` wrapper, the ``run(mode=...)`` dispatcher, the
vectorized HadarE backend — tracker aggregation and quota re-splitting
as (parent × copy) NumPy matrix ops, with steady-round fast-forward —
and ``simulate_pods``), ``faults`` (``FailureModel``, validated
``FailureTrace`` windows, checkpoint rollback and the reverse-payoff
eviction policy) and ``replay`` (Philly/Helios-style job and
failure-trace CSVs).
"""
from repro_torch.sim.engine import (RESTART_PENALTY, ConsultPoint,
                                    event_stream, simulate_events,
                                    simulate_rounds)
from repro_torch.sim.faults import (CHECKPOINT_INTERVAL, FailureModel,
                                    FailureTrace, FaultWindow)
from repro_torch.sim.metrics import (EventSimResult, IntervalRecord,
                                     RoundRecord, SimResult)

__all__ = [
    "CHECKPOINT_INTERVAL",
    "ConsultPoint",
    "RESTART_PENALTY",
    "event_stream",
    "FailureModel",
    "FailureTrace",
    "FaultWindow",
    "simulate_events",
    "simulate_rounds",
    "EventSimResult",
    "IntervalRecord",
    "RoundRecord",
    "SimResult",
]
