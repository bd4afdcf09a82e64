"""Port vs JAX package: N-way queries through ``JoinSession.execute``.

A 4-way chain and a 5-way star (binary steps feeding a fused root, or an
all-binary cascade) under ``strategy`` None / "3way" / "cascade", and
per-R counts on the chain.  Exact equality of count, rounds, tuples_read,
kind, strategy, ``plan.describe()`` and cache behaviour (the shared
checks live in ``test_torch_session.py``).
"""

import pytest

from test_torch_session import check_execute, check_per_r


@pytest.mark.parametrize("name", ["chain4", "star5"])
@pytest.mark.parametrize("strategy", [None, "3way", "cascade"])
def test_nway_execute_matches_reference(name, strategy):
    check_execute(name, strategy)


def test_nway_per_r_matches_reference():
    check_per_r("chain4")
