"""Losses, the analytic memory model, and the legacy MBS facades."""
from . import losses, memory_model, mbs, streaming  # noqa: F401
from .mbs import (MBSConfig, make_baseline_train_step,  # noqa: F401
                  make_mbs_train_step, mbs_gradients, num_micro_batches,
                  split_minibatch)
