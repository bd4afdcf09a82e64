"""Measured-constant calibration for the Appendix-A time model.

The closed-form cycle model (``perfmodel.model``) compares a fused 3-way
root against a binary cascade with HAND-SET hardware constants.  Those
constants describe Plasticine, not the machine the bench actually runs on —
and the ``cascade_4way`` bench showed the failure mode: the model picked
the fused root at a scale where the measured binary tail was faster.

This module closes the loop: a bench report records, next to each
measured time, the model's own predicted seconds for the same root
(``model_t3_s`` / ``model_tc_s`` from the planner's ``TimedChoice``).
``calibration_from_bench`` turns one such report into a
:class:`Calibration` — two multiplicative scales (measured / predicted, one
per plan family) that ``planner.choose_linear_timed`` /
``choose_star_timed`` apply before comparing totals.  A scale is a pure
re-anchoring: the model keeps its shape (how times grow with n, d, M), the
bench pins its absolute level on THIS machine.

Calibration is opt-in (``JoinSession(calibration=...)``): the default
``None`` keeps the paper's hand-set constants, so published Fig-4 model
numbers and small-scale planning behavior are untouched.

The port's files are its own: the bench report ``BENCH_torch.json``
(``BENCH_FILE``, written by the port's bench on the card) and the snapshot
``CALIBRATION_torch.json`` (``CALIBRATION_FILE``).  The JAX package's
``BENCH_engine.json`` and ``CALIBRATION_engine.json`` describe another
machine and are read or written only when a caller passes their path.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping

# measured/predicted ratios outside this band are treated as a corrupt
# record rather than a constant to bake in.  The band is WIDE on purpose:
# the hand-set constants model Plasticine cycles, so a CPU runner's
# measured/predicted ratio sits around 1e3-1e4 legitimately.
_MAX_SCALE = 1e7


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Multiplicative re-anchoring of the Appendix-A closed forms.

    ``fused3_scale`` multiplies the fused 3-way root's predicted total,
    ``cascade_scale`` the binary cascade's, before the planner compares
    them.  ``source`` records provenance for plan-cache keys and debug
    output.  The identity calibration reproduces the uncalibrated model.
    """

    fused3_scale: float = 1.0
    cascade_scale: float = 1.0
    source: str = "identity"

    def scaled(self, t_3way_s: float, t_cascade_s: float):
        return t_3way_s * self.fused3_scale, t_cascade_s * self.cascade_scale


IDENTITY = Calibration()


def calibration_from_bench(bench: Mapping[str, Any] | str | pathlib.Path,
                           *, shape: str = "cascade_4way") -> Calibration:
    """Build a :class:`Calibration` from a bench report (a path or the
    parsed JSON; the port's is ``BENCH_FILE``).

    Reads the named shape's measured per-path seconds (``fused_root_s``:
    the fused root step's blocked wall time; ``binary_tail_s``: the
    all-binary root steps') and the model's predicted seconds for the same
    decision (``model_t3_s`` / ``model_tc_s``).  Missing or degenerate
    entries fall back to the identity calibration rather than guessing —
    and a single implausible ratio degrades BOTH scales to identity:
    re-anchoring only one side would skew the 3-way/cascade comparison
    worse than no calibration at all.
    """
    if isinstance(bench, (str, pathlib.Path)):
        path = pathlib.Path(bench)
        if not path.exists():
            return IDENTITY
        bench = json.loads(path.read_text())
    row = bench.get("shapes", {}).get(shape, {})
    needed = ("fused_root_s", "binary_tail_s", "model_t3_s", "model_tc_s")
    if any(not isinstance(row.get(k), (int, float)) or row[k] <= 0
           for k in needed):
        return IDENTITY
    f3 = row["fused_root_s"] / row["model_t3_s"]
    cs = row["binary_tail_s"] / row["model_tc_s"]
    if not all(1.0 / _MAX_SCALE <= s <= _MAX_SCALE for s in (f3, cs)):
        return IDENTITY
    return Calibration(fused3_scale=float(f3), cascade_scale=float(cs),
                       source=f"bench:{shape}")


# ---------------------------------------------------------------------------
# persistence: the committed calibration file
# ---------------------------------------------------------------------------

# The port's bench report and the calibration snapshot derived from it.  A
# bench that refreshes the snapshot after every run (through
# ``refresh_calibration_file``) keeps ``calibration_from_file`` from reading
# constants staler than the last report.  A missing report gives the
# identity calibration.
BENCH_FILE = "BENCH_torch.json"
CALIBRATION_FILE = "CALIBRATION_torch.json"


def refresh_calibration_file(bench: Mapping[str, Any] | str | pathlib.Path
                             = BENCH_FILE,
                             out_path: str | pathlib.Path = CALIBRATION_FILE,
                             *, shape: str = "cascade_4way") -> Calibration:
    """Re-derive the calibration from ``bench`` and persist it to
    ``out_path``.  Returns the calibration written (the identity one when
    the bench record is missing or degenerate — persisted too, so a stale
    non-identity file cannot outlive the report that justified it)."""
    cal = calibration_from_bench(bench, shape=shape)
    payload = {"fused3_scale": cal.fused3_scale,
               "cascade_scale": cal.cascade_scale,
               "source": cal.source, "shape": shape}
    pathlib.Path(out_path).write_text(json.dumps(payload, indent=2) + "\n")
    return cal


def calibration_from_file(path: str | pathlib.Path = CALIBRATION_FILE
                          ) -> Calibration:
    """Load the committed calibration snapshot; identity when absent or
    malformed (same never-guess posture as ``calibration_from_bench``)."""
    p = pathlib.Path(path)
    if not p.exists():
        return IDENTITY
    try:
        payload = json.loads(p.read_text())
        f3 = float(payload["fused3_scale"])
        cs = float(payload["cascade_scale"])
    except (ValueError, KeyError, TypeError):
        return IDENTITY
    if not all(1.0 / _MAX_SCALE <= s <= _MAX_SCALE for s in (f3, cs)):
        return IDENTITY
    return Calibration(fused3_scale=f3, cascade_scale=cs,
                       source=str(payload.get("source", f"file:{p}")))
