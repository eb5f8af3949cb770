"""Engine contract checker of the port — the reference's
``repro.analysis``, with the same rule ids, ``Finding`` / ``Report``
vocabulary and exit codes, checking the port's eager steps.

Three inspection layers:

  * ``trace_checks`` — contracts on the RECORDED train step (one real
    step under ``engine.steptrace.record``, the reference's jaxpr):
    accumulator dtype (JX001), remat policy applied (JX002), no host
    reads (JX003), collective census (JX004), the pipelined 1F1B census
    (JX005);
  * ``step_checks`` — contracts on the MEASURED step (its storages,
    peak and collectives, the reference's compiled HLO): in-place update
    (HLO001), unexpected all-gathers (HLO002), memory-model cross-check
    (HLO003), one all-reduce per mini-batch (HLO004), the pipelined
    schedule (HLO005);
  * ``lint`` — AST rules over ``src/repro_torch`` (LINT001–LINT006),
    waivable inline with ``# repro: noqa(RULE)``;
  * ``serve_checks`` — the serving decode step: the KV pool written in
    place (SRV001) and the decode peak against the serve model and the
    budget (SRV002).

``suite.run_suite`` wires them over real reduced configurations;
``python -m repro_torch.analysis`` is the CLI gate and shares the
exit-code contract (0 ok / 1 error / 2 budget / 3 contract violation)
with ``launch/dryrun.py``.
"""
from .findings import (EXIT_BUDGET, EXIT_CONTRACT, EXIT_ERROR,  # noqa: F401
                       EXIT_OK, Finding, Report, RULES,
                       SEVERITY_ERROR, SEVERITY_WARNING)
from .trace_checks import (accumulator_writes, check_accum_dtype,  # noqa: F401
                           check_collectives, check_gspmd_collectives,
                           check_host_reads,
                           check_pipeline_collectives, check_pipelined_step,
                           check_remat_policy, check_train_step,
                           pipeline_census, remat_census)
from .step_checks import (allreduce_count, check_aliasing,  # noqa: F401
                          check_gradient_sync, check_memory_model,
                          check_pipeline_step,
                          check_unexpected_ops, collective_bytes,
                          measured_peak_bytes, tree_bytes)
from .lint import (category_for, lint_paths, lint_repo,  # noqa: F401
                   lint_source)
from .suite import (MEMORY_TOLERANCE, TARGETS, check_bundle,  # noqa: F401
                    check_gspmd_rank, check_gspmd_serve_rank, check_step,
                    run_suite)
from .serve_checks import (SERVE_TARGETS, build_decode,  # noqa: F401
                           check_decode_aliasing, check_decode_memory,
                           measure_decode, run_serve_suite)
