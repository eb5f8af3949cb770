"""MBS execution engine of the port: the planner (``plan.py``), the
flat-buffer layout (``flat.py``), the shared Algorithm 1 core
(``exec_core.py``) and the executors (``executors.py``)."""
from .executors import (EXECUTORS, CompiledScanExecutor,  # noqa: F401
                        FlatFusedExecutor, FusedAccumExecutor, get_executor)
from .flat import FlatSpec, LeafSlot  # noqa: F401
from .plan import (MBSPlan, num_micro_batches, plan_mbs,  # noqa: F401
                   split_minibatch)
