"""Fault tolerance: restartable step loop, straggler detection, elastic
restore.  The control-plane logic of the JAX package's module, copied
(it is pure Python) so that the port imports none of it.

On a real multi-pod fleet the failure modes are: host preemption (SIGTERM
→ checkpoint + exit), hardware loss (process dies → restart from latest
committed checkpoint), and stragglers (slow host stretches every
collective).  This module implements the control-plane logic in a
backend-agnostic way:

  * RestartableLoop — run(step_fn) with checkpoint cadence, SIGTERM-safe
    final save, crash-resume from the newest *committed* checkpoint, and a
    simulated-failure hook used by the integration tests.
  * StragglerMonitor — per-step wall-time EMA + z-score flagging; on a real
    fleet the flag feeds the scheduler's eviction hook (here: logged and
    surfaced in metrics; tests assert detection).
  * elastic_restore — restore a checkpoint written under any device count
    onto this process's device (checkpoints are host-format; the device is
    applied at restore, where the JAX package applies shardings).

A port step function updates its state in place; the loop holds whatever
it returns.  Without a checkpoint directory (``manager=None``) the loop
saves nothing, not even on SIGTERM.  ``run`` restores the SIGTERM handler
it found when it returns, so a process that goes on after training still
ends on SIGTERM.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerStats:
    mean: float
    std: float
    last: float
    z: float
    flagged: bool


class StragglerMonitor:
    """EMA-based step-time outlier detector (z > threshold ⇒ straggler)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 4.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self._mean = 0.0
        self._var = 0.0
        self._n = 0
        self.flags: list[int] = []

    def observe(self, step: int, dt: float) -> StragglerStats:
        self._n += 1
        if self._n <= self.warmup:
            # prime the EMA on the warmup window
            w = 1.0 / self._n
            self._mean = (1 - w) * self._mean + w * dt
            self._var = (1 - w) * self._var + w * (dt - self._mean) ** 2
            return StragglerStats(self._mean, self._var ** 0.5, dt, 0.0,
                                  False)
        std = max(self._var ** 0.5, 1e-6, 0.05 * self._mean)
        z = (dt - self._mean) / std
        flagged = z > self.threshold
        if flagged:
            self.flags.append(step)
        else:
            # only adapt the EMA on non-outliers (don't learn the straggler)
            self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
            self._var = ((1 - self.alpha) * self._var
                         + self.alpha * (dt - self._mean) ** 2)
        return StragglerStats(self._mean, std, dt, z, flagged)


def elastic_restore(template, directory, device=None, step=None):
    """Restore the newest committed checkpoint onto ``device`` — the
    device count at save time is irrelevant (host-format arrays)."""
    from repro_torch.checkpoint import restore_pytree
    return restore_pytree(template, directory, step=step, device=device)


class RestartableLoop:
    """Crash-safe training loop driver.

    state = loop.run(state, step_fn, data_iter, n_steps)
      * resumes from the newest committed checkpoint if one exists
      * checkpoints every `every` steps and on SIGTERM
      * `fail_at` (test hook) raises mid-run to simulate a node loss
    """

    def __init__(self, manager: CheckpointManager | None, *,
                 log: Callable[[str], None] = print,
                 monitor: StragglerMonitor | None = None):
        self.manager = manager
        self.log = log
        self.monitor = monitor or StragglerMonitor()
        self._stop = False

    def _install_sigterm(self):
        """Install the stop handler; returns the one it replaced (None
        off the main thread)."""
        def handler(signum, frame):
            self._stop = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not on main thread (tests)

    def resume_step(self, state_template, device=None):
        """(state, start_step): restored, or (None, 0) without a committed
        checkpoint."""
        last = None if self.manager is None else self.manager.latest_step()
        if last is None:
            return None, 0
        state, manifest = self.manager.restore(state_template,
                                               device=device)
        self.log(f"[ft] resumed from committed step {last}")
        return state, int(manifest["step"])

    def run(self, state: Any, step_fn, batch_for_step, n_steps: int,
            start_step: int = 0, fail_at: int | None = None,
            metrics_cb=None):
        previous = self._install_sigterm()
        try:
            return self._run(state, step_fn, batch_for_step, n_steps,
                             start_step, fail_at, metrics_cb)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, state, step_fn, batch_for_step, n_steps, start_step,
             fail_at, metrics_cb):
        saving = self.manager is not None
        step = start_step
        while step < n_steps and not self._stop:
            t0 = time.monotonic()
            batch = batch_for_step(step)
            state, metrics = step_fn(state, batch)
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            dt = time.monotonic() - t0
            stats = self.monitor.observe(step, dt)
            if stats.flagged:
                self.log(f"[ft] straggler step {step}: {dt:.3f}s "
                         f"(z={stats.z:.1f}) — would evict/requeue host")
            if metrics_cb:
                metrics_cb(step, metrics, stats)
            step += 1
            if saving and self.manager.should_save(step):
                self.manager.save(state, step)
                self.log(f"[ft] checkpoint @ step {step}")
        if self._stop and saving:
            self.manager.save(state, step)
            self.log(f"[ft] SIGTERM checkpoint @ step {step}")
        return state, step
