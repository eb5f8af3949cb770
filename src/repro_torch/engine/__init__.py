"""MBS execution engine of the port: the planner (``plan.py``), the
flat-buffer layout (``flat.py``), the shared Algorithm 1 core
(``exec_core.py``), the executors (``executors.py``), the async input
pipeline (``pipeline.py``), the resumable loop (``trainer.py``) and the
fault-injection harness (``faults.py``)."""
from .plan import (MBSConfig, MBSPlan, num_micro_batches,  # noqa: F401
                   plan_mbs, split_minibatch)
from .flat import FlatSpec, LeafSlot  # noqa: F401
from .executors import (EXECUTORS, CompiledScanExecutor,  # noqa: F401
                        FlatFusedExecutor, FusedAccumExecutor,
                        StreamingExecutor, accumulate_gradients,
                        get_executor, make_baseline_train_step)
from .pipeline import Pipeline, PipelineStats  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import faults  # noqa: F401
