"""Invariant lint suite and runtime race sanitizer of the port (DESIGN.md §11),
the counterpart of the JAX package's ``repro.analysis``:

  * ``python -m repro_torch.analysis`` — AST lint over ``src/repro_torch/``
    with five rules in torch vocabulary (``rules.py``), a baseline diff
    gate against the port's own ``baseline.json`` (``engine.py``), and the
    JAX package's ``# repro: allow[rule-id]`` inline suppressions;
  * ``python -m repro_torch.analysis --dead-code`` — import-graph
    reachability report from the port's entry points (``deadcode.py``);
  * ``racecheck`` — opt-in (``REPRO_SANITIZE=1``) instrumentation that wraps
    engine entry points with owner/epoch tokens and raises
    :class:`~repro_torch.analysis.racecheck.RaceViolation` on cross-thread
    query-vs-mutation overlap.

Everything here is stdlib + numpy only — no torch, no jax, nothing of
``repro`` — so the analyzer runs on bare CI runners.
"""
from .engine import Finding, Module, load_baseline, run_rules  # noqa: F401
