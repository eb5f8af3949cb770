from .optimizers import (FusedUpdateSpec, Optimizer, adam, adamw,  # noqa: F401
                         clip_by_global_norm, constant, cosine_decay,
                         linear_decay, memory_model_kw, norm_reducer, sgd,
                         sharded_norm)
