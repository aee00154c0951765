"""Runtime checks of the port's invariants (DESIGN.md §11).

  * ``racecheck`` — opt-in (``REPRO_SANITIZE=1``) instrumentation that wraps
    engine entry points with owner/epoch tokens and raises
    :class:`~repro_torch.analysis.racecheck.RaceViolation` on cross-thread
    query-vs-mutation overlap.

Stdlib only.  The lint suite of the JAX package is not ported yet.
"""
