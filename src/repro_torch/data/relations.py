"""Synthetic relation generators for the join workloads (paper §6).

The paper's workloads are parameterized by (N records, d distinct values) —
"average friends per person" f = N/d.  Uniform by default; Zipf skew
available for the §1.2 skew-handling tests.  The numpy draws are the JAX
package's, so both packages build the same columns from one seed; the
relation lands on ``device`` (None: the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.relation import Relation


@dataclasses.dataclass(frozen=True)
class RelGenConfig:
    n: int                  # records
    d: int                  # distinct values per column
    columns: tuple = ("a", "b")
    zipf: float = 0.0       # 0 = uniform
    seed: int = 0
    capacity: int = 0       # 0 = exactly n


def gen_relation(cfg: RelGenConfig, *, device=None) -> Relation:
    cols = {}
    for i, c in enumerate(cfg.columns):
        r = np.random.default_rng(cfg.seed * 7 + i)
        if cfg.zipf:
            v = np.minimum(r.zipf(cfg.zipf, size=cfg.n), cfg.d) - 1
        else:
            v = r.integers(0, cfg.d, size=cfg.n)
        cols[c] = v.astype(np.int32)
    return Relation.from_arrays(capacity=cfg.capacity or cfg.n,
                                device=device, **cols)


def friends_relation(n: int, d: int, seed: int = 0, *,
                     device=None) -> Relation:
    """The paper's friends(F) relation: n edges over d users."""
    return gen_relation(RelGenConfig(n=n, d=d, columns=("a", "b"),
                                     seed=seed), device=device)
