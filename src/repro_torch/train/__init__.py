"""The train step (``TrainState``, ``init_train_state``,
``cross_entropy_loss``, ``make_train_step``) and the serve steps
(``make_prefill_step``, ``make_decode_step``)."""

from repro_torch.train.steps import (  # noqa: F401
    TrainState, cross_entropy_loss, init_train_state, make_decode_step,
    make_prefill_step, make_train_step)
