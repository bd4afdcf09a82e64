"""Sequence parallelism over "model" (``parallel/sequence_parallel.py``)
in one process, on the dry-run's fake world: ``split``'s decisions (the
rule off, S not dividing "model", decode's S = 1, manual mode, no
context) and the sequence operators' shapes and the collectives they
count.  The parity cases against the JAX package's GSPMD ride the shared
(4, 2) launch (``tests/test_torch_lm_mesh.py``); the gradients and
planted faults on two gloo ranks are ``tests/test_torch_fsdp.py``'s.
"""

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.parallel import sequence_parallel as seqp
from repro_torch.parallel import sharding as shd


@pytest.fixture
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
    shd.set_context(None)


def test_split_follows_spec_for(fake_mesh):
    shd.set_context(fake_mesh)
    assert seqp.split((4, 16, 8)) is None              # seq_res -> ()
    shd.set_context(fake_mesh, seqp.RULES)
    sp = seqp.split((4, 16, 8))
    assert sp is not None and sp.size == 2
    assert seqp.split((4, 15, 8)) is None              # S odd
    assert seqp.split((4, 1, 8)) is None               # decode
    with shd.manual_mode():
        assert seqp.split((4, 16, 8)) is None
    shd.set_context(None)
    assert seqp.split((4, 16, 8)) is None
    assert seqp.current() is None


def test_sequence_operators_shapes_and_counts(fake_mesh):
    shd.set_context(fake_mesh, seqp.RULES)
    sp = seqp.split((2, 8, 3))
    x = torch.randn((2, 4, 3), requires_grad=True)
    seqp.reset_counts()
    whole = seqp.gather(x, sp)
    assert whole.shape == (2, 8, 3)
    part = seqp.reduce_scatter(whole * 2, sp)
    assert part.shape == (2, 4, 3)
    mine = seqp.scatter(whole, sp)
    assert mine.shape == (2, 4, 3)
    (part.sum() + mine.sum()).backward()
    assert x.grad.shape == (2, 4, 3)
    nbytes = 2 * 8 * 3 * 4
    # gather (forward) and the two all-gathers of the backward; the
    # reduce-scatter forward and the gather's backward
    assert seqp.COUNTS == {"all_gather": [3, 3 * nbytes],
                           "reduce_scatter": [2, 2 * nbytes]}
    with seqp.stream(sp):
        assert seqp.current() is sp
    assert seqp.current() is None
