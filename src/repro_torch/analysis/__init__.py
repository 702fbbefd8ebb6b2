"""The port's runtime sanitizer (``repro_torch.analysis.invariants``): an
opt-in check of the paper's primal-dual invariants (``REPRO_SANITIZE=1``
or ``sanitize=True``) inside ``PriceState``, ``dp_allocation``, the
batched solver, both engines, HadarE and the env.

The JAX package's static lint passes are not copied: its linter already
covers ``src/repro_torch``.
"""
from repro_torch.analysis.invariants import (InvariantViolation,
                                             sanitize_enabled)

__all__ = ["InvariantViolation", "sanitize_enabled"]
