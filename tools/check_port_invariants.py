#!/usr/bin/env python
"""Gate: run the port's invariant lint (``repro_torch.analysis.
lint_invariants``) over the port's sources, ``chip_smoke.py``, the ported
examples (``examples/*_torch.py``) and this file.  Exits nonzero on any
finding — besides the exactness rules it shares with the reference's lint
(one Relation mutation point, oracle-only np.unique, SENTINEL-derived
sentinels, integer count accumulation), it holds the port to its dispatch
rules: no import of jax or the reference package, no ``use_kernel`` flag,
no CPU default for a ``device``, no fallback around a kernel call.

    python tools/check_port_invariants.py [paths...]
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import lint_invariants  # noqa: E402


def default_paths() -> list[str]:
    return [str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py"),
            *map(str, sorted((ROOT / "examples").glob("*_torch.py"))),
            str(pathlib.Path(__file__).resolve())]


if __name__ == "__main__":
    raise SystemExit(lint_invariants.main(sys.argv[1:] or default_paths()))
