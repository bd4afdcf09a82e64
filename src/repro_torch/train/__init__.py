"""The serve steps (``make_prefill_step``, ``make_decode_step``); the
train step comes with the training slice."""

from repro_torch.train.steps import (  # noqa: F401
    make_decode_step, make_prefill_step)
