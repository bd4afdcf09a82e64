"""Opt-in shadow of ``execute_plan``'s refcounting buffer arena.

The executor overlaps aggressively: ``stage_ready`` dispatches stage 1 of
later binary steps the moment their inputs are live and releases those
inputs *at capture time*, long before the step's total is synced.  The
refcount bookkeeping that makes this safe ("drop each ``%i<k>`` exactly
when its last consumer has captured it") is easy to break when the
dispatch order changes — and the failure mode is not a crash but a
KeyError three steps later, or a buffer silently held for the whole walk.

This module is a shadow arena that recomputes the expected consumer count
per environment name independently from the plan, then audits every
release/drop/produce event the executor emits:

* a release past zero is a **double release**;
* a drop (eviction from the environment) while consumers remain is a
  **release-before-last-consumer** — a later step would read a dead
  buffer;
* a ``%``-named buffer still resident at the end of the walk (without
  ``keep_intermediates``), or expected consumers that never arrived, is a
  **leak** / lost consumer.

Enablement is opt-in because the hooks sit on the executor's hot loop:
set ``REPRO_SANITIZE_ARENA=1`` (the CI pytest matrix does), or wrap a
block in :func:`enabled` — ``with arena_sanitizer.enabled(): ...``.
Violations raise :class:`ArenaSanitizerError` (a ``RuntimeError``: these
are executor bugs, not plan validation failures).

:func:`check_residents` is the streaming-side audit: a standing query's
resident intermediates must be exactly the plan's materialized outs.
"""

from __future__ import annotations

import contextlib
import os

_FORCED = 0      # nesting depth of enabled() context managers


def active() -> bool:
    """True when the sanitizer should shadow the next plan walk."""
    return _FORCED > 0 or os.environ.get("REPRO_SANITIZE_ARENA", "") not in (
        "", "0")


@contextlib.contextmanager
def enabled():
    """Force the sanitizer on for a block, regardless of the env var."""
    global _FORCED
    _FORCED += 1
    try:
        yield
    finally:
        _FORCED -= 1


class ArenaSanitizerError(RuntimeError):
    """The executor's arena bookkeeping diverged from the plan."""


class ArenaShadow:
    """Shadow arena for one ``execute_plan`` walk.  The executor calls
    ``on_release`` / ``on_drop`` / ``on_produce`` as events happen and
    ``finish`` before returning."""

    def __init__(self, plan, relations, keep_intermediates: bool):
        self._keep = keep_intermediates
        # independent recomputation of the executor's `readers` map
        self._left: dict[str, int] = {}
        for step in plan.steps:
            for name in step.inputs:
                self._left[name] = self._left.get(name, 0) + 1
        self._produced: set[str] = set()
        self._base: set[str] = set(relations)
        self._dropped: set[str] = set()

    def on_produce(self, name: str) -> None:
        if name in self._produced:
            raise ArenaSanitizerError(
                f"arena shadow: {name!r} produced twice — a step "
                "overwrote a live intermediate")
        if name in self._dropped:
            raise ArenaSanitizerError(
                f"arena shadow: {name!r} produced after it was dropped")
        self._produced.add(name)

    def on_release(self, name: str) -> None:
        left = self._left.get(name)
        if left is None:
            raise ArenaSanitizerError(
                f"arena shadow: release of {name!r}, which no step "
                "consumes")
        if left <= 0:
            raise ArenaSanitizerError(
                f"arena shadow: double release of {name!r} — every "
                "consumer already released it")
        self._left[name] = left - 1

    def on_drop(self, name: str) -> None:
        """The executor evicted ``name`` from the environment."""
        if self._left.get(name, 0) > 0:
            raise ArenaSanitizerError(
                f"arena shadow: {name!r} dropped while "
                f"{self._left[name]} consumer(s) have not captured it — "
                "release-before-last-consumer")
        if self._keep and name.startswith("%"):
            raise ArenaSanitizerError(
                f"arena shadow: {name!r} dropped under "
                "keep_intermediates=True — standing queries need it "
                "resident")
        self._dropped.add(name)

    def finish(self, env) -> None:
        pending = {n: c for n, c in self._left.items() if c > 0}
        if pending:
            raise ArenaSanitizerError(
                "arena shadow: walk finished with unconsumed inputs "
                f"{sorted(pending)} — a consumer never released them")
        if not self._keep:
            leaked = sorted(n for n in env
                            if n.startswith("%") and n in self._produced)
            if leaked:
                raise ArenaSanitizerError(
                    f"arena shadow: intermediates {leaked} leaked — still "
                    "resident after their last consumer released them")


def begin(plan, relations, keep_intermediates: bool) -> ArenaShadow | None:
    """Start a shadow for one plan walk, or ``None`` when inactive."""
    if not active():
        return None
    return ArenaShadow(plan, relations, keep_intermediates)


def check_residents(plan, residents) -> None:
    """Streaming audit: a standing query's resident intermediates must be
    exactly the plan's materialized (non-aggregate binary) outs."""
    if not active():
        return
    expected = {s.out for s in plan.steps
                if s.op == "binary" and not s.aggregate}
    got = set(residents)
    missing = sorted(expected - got)
    extra = sorted(n for n in got - expected if n.startswith("%"))
    if missing or extra:
        raise ArenaSanitizerError(
            "arena shadow: standing-query residents diverge from the "
            f"plan: missing {missing}, unexpected {extra}")
