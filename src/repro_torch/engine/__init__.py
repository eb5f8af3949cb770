"""MBS execution engine of the port: the planner (``plan.py``), the
flat-buffer layout (``flat.py``), the shared Algorithm 1 core
(``exec_core.py``), the executors (``executors.py``), the async input
pipeline (``pipeline.py``), the resumable loop (``trainer.py``), the
fault-injection harness (``faults.py``), the fault-tolerant
``Supervisor`` (``supervisor.py``: OOM degrade-and-resume, the NaN
guard's retry and skip, bounded I/O retries, give-ups as exit codes
40–44) and the autotuner (``autotune.py``: the memory oracle behind
``plan_mbs(calibrate=)`` and the kernels' block tuner, whose resolver is
installed on import), serving (``serving.py``, ``kv.py``: KV-slot
admission by ``plan_serve`` and the continuous-batching engine), and
data parallelism (``sharded.py``: the ``ShardedExecutor``, one flat
all-reduce per mini-batch over ``torch.distributed``) and pipeline
parallelism (``pipelined.py``: the 1F1B ``PipelinedExecutor`` over a
``(data, model)`` mesh, ``StagedLoss``, ``schedule_1f1b``) and the
model split over a GSPMD mesh (``gspmd.py``: the ``GspmdExecutor``,
tensor and FSDP sharding by the reference's ``param_specs``), and the
recorded step (``steptrace.py``: every executor's ``trace_step`` /
``measure_step``, which ``repro_torch.analysis`` checks)."""
from .plan import (MBSConfig, MBSPlan, num_micro_batches,  # noqa: F401
                   plan_mbs, split_minibatch)
from .autotune import (TuningCache, calibrate_memory,  # noqa: F401
                       get_cache, set_cache_path, tune_block_sizes,
                       tune_for_params)
from .flat import FlatSpec, LeafSlot  # noqa: F401
from .executors import (EXECUTORS, CompiledScanExecutor,  # noqa: F401
                        FlatFusedExecutor, FusedAccumExecutor,
                        StreamingExecutor, accumulate_gradients,
                        get_executor, make_baseline_train_step)
from .sharded import (ShardedExecutor, collective_stats,  # noqa: F401
                      psum_flat, reset_collective_stats, time_collectives)
from .pipelined import (PipelinedExecutor, StagedLoss,  # noqa: F401
                        p2p_counts, schedule_1f1b)
from .gspmd import CollectiveCensus, GspmdExecutor  # noqa: F401
from .pipeline import Pipeline, PipelineStats  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .supervisor import (FaultRecord, NaNCircuitBreaker, NaNHalt,  # noqa: F401
                         PlanExhausted, RestartBudgetExceeded, Supervisor,
                         SupervisorConfig, SupervisorError, degrade_plan)
from . import faults, steptrace  # noqa: F401
from .kv import KVPool, PoolExhausted  # noqa: F401
from .serving import (Request, ServePlan, ServingEngine,  # noqa: F401
                      check_servable, plan_serve, synthetic_traffic)
