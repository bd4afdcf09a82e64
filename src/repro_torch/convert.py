"""Carry relations between numpy, the port and the JAX package's layout.

There are no weights: the state of a join is the relations' columns and
validity.  These helpers build the port's relations from numpy arrays (and
back), so the tests and the smoke run feed both packages the same data.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.relation import Relation, as_int32, resolve_device


def relation_from_numpy(columns: Mapping[str, np.ndarray], valid=None,
                        capacity: int | None = None, device=None) -> Relation:
    """A Relation from equal-length numpy columns.

    Without ``valid`` every given row is live and ``capacity`` pads with
    dead rows; with ``valid`` the arrays already span the capacity and
    ``valid`` marks the live slots.  ``device=None`` means the card.
    """
    if valid is None:
        return Relation.from_arrays(capacity=capacity, device=device,
                                    **columns)
    dev = resolve_device(device)
    valid = np.array(valid, dtype=bool)
    cols = {k: as_int32(v, dev) for k, v in columns.items()}
    for k, v in cols.items():
        if v.shape != valid.shape:
            raise ValueError(f"column {k!r} has shape {tuple(v.shape)}, "
                             f"valid has {valid.shape}")
    if capacity is not None and capacity != valid.shape[0]:
        raise ValueError(f"capacity {capacity} != {valid.shape[0]} slots")
    return Relation(cols, torch.from_numpy(valid).to(dev))


def relation_to_numpy(rel: Relation) -> dict:
    """``{"columns": {name: int32 array}, "valid": bool array,
    "capacity": int}`` — every slot, padding included."""
    return {"columns": {k: v.cpu().numpy() for k, v in rel.columns.items()},
            "valid": rel.valid.cpu().numpy(),
            "capacity": rel.capacity}


def relation_from_reference_arrays(d: Mapping, device=None) -> Relation:
    """The port's Relation from the numpy arrays of a JAX-package Relation:
    ``{"columns": {...}, "valid": ..., "capacity": ...}`` (the shape
    ``relation_to_numpy`` returns), padding slots included."""
    return relation_from_numpy(d["columns"], valid=d["valid"],
                               capacity=d.get("capacity"), device=device)
