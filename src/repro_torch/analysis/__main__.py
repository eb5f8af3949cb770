"""CLI gate: ``python -m repro_torch.analysis``.

Runs the contract-check suite over a (config × executor × mesh) matrix
and exits with the repo-wide code contract: 0 clean, 1 tool error, 3
contract findings. ``--json``/``--out`` emit the machine-readable
report. The steps run on the card unless ``--device cpu`` is given.

Examples::

    python -m repro_torch.analysis --lint-only
    python -m repro_torch.analysis --device cpu --config qwen2_reduced \\
        --executor flat --executor compiled --mesh host --ranks 2
    python -m repro_torch.analysis --device cpu --config qwen2_reduced \\
        --mesh 1:2
    python -m repro_torch.analysis --device cpu --no-hlo
    python -m repro_torch.analysis --device cpu --serve [--no-donate] \
        [--mesh host|2:1]
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract checks over recorded and measured train and "
                    "decode steps + the port's lint")
    ap.add_argument("--config", action="append", default=None,
                    help="target name (repeatable; default qwen2_reduced). "
                         "Known: see repro_torch.analysis.TARGETS")
    ap.add_argument("--executor", action="append", default=None,
                    help="executor name (repeatable; default flat)")
    ap.add_argument("--mesh", default="single",
                    help="'single' (this process), 'host' (a world of "
                         "--ranks spawned ranks on the data axis: the "
                         "sharded deferred-sync contract), or 'DATA:MODEL' "
                         "(e.g. '1:2': MODEL > 1 runs the pipelined 1F1B "
                         "contracts JX005/HLO005; with --serve, the "
                         "data-parallel serve plan and one rank's decode); "
                         "the reference's suite has no 'production' mesh: "
                         "its gate is launch.dryrun --mesh production "
                         "--check")
    ap.add_argument("--ranks", type=int, default=2, metavar="N",
                    help="ranks of the --mesh host world (default 2)")
    ap.add_argument("--remat-policy", default=None,
                    help="override the remat lattice row (default: the "
                         "target's shipped policy)")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the measured-step layer (HLO001-HLO005): "
                         "the recorded step's trace rules and the lint "
                         "only")
    ap.add_argument("--lint-only", action="store_true",
                    help="run only the AST lint over src/repro_torch")
    ap.add_argument("--serve", action="store_true",
                    help="run the serving decode-step contracts "
                         "(SRV001/SRV002) instead of the training suite; "
                         "--config picks archs (default: "
                         "repro_torch.analysis.SERVE_TARGETS)")
    ap.add_argument("--no-donate", action="store_true",
                    help="serve with an undonated pool (SRV001 fires)")
    ap.add_argument("--memory-tolerance", type=float, default=None,
                    help="HLO003/SRV002 modeled-vs-measured factor "
                         "(default 16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the steps run")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report to stdout")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)
    if not args.lint_only:
        import torch
        device = torch.device(args.device)
        if device.type not in ("cuda", "cpu"):
            ap.error(f"--device must be cuda or cpu, got {args.device!r}")
        if device.type == "cuda" and not torch.cuda.is_available():
            ap.error("--device cuda: no CUDA device is available here; "
                     "pass --device cpu to run on the CPU")
    return args


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    from . import findings as F
    from . import lint as lint_mod
    from . import suite as suite_mod

    reports = []
    tool_error = False
    if args.lint_only:
        try:
            rep = F.Report(context={"mode": "lint-only"})
            rep.extend(lint_mod.lint_repo(), "LINT")
            reports.append(rep)
        except Exception:  # the tool itself failed: exit 1
            traceback.print_exc()
            return F.EXIT_ERROR
    elif args.serve:
        from . import serve_checks
        for arch in args.config or list(serve_checks.SERVE_TARGETS):
            try:
                kw = {}
                if args.memory_tolerance is not None:
                    kw["tolerance"] = args.memory_tolerance
                reports.append(serve_checks.run_serve_suite(
                    arch, mesh=args.mesh, donate=not args.no_donate,
                    device=args.device, ranks=args.ranks, **kw))
            except Exception:  # one combo crashing is exit 1, not a hang
                traceback.print_exc()
                print(f"ERROR: serve suite crashed on {arch} (see above)",
                      file=sys.stderr)
                tool_error = True
    else:
        kw = {}
        if args.memory_tolerance is not None:
            kw["memory_tolerance"] = args.memory_tolerance
        targets = args.config or ["qwen2_reduced"]
        executors = args.executor or ["flat"]
        lint_once = True
        for t in targets:
            for ex in executors:
                # one combo crashing must not sink the rest of the
                # matrix — record it and keep going (exit 1 at the end)
                try:
                    reports.append(suite_mod.run_suite(
                        t, executor=ex, mesh=args.mesh,
                        remat_policy=args.remat_policy, lint=lint_once,
                        device=args.device, ranks=args.ranks,
                        hlo=not args.no_hlo, **kw))
                    lint_once = False  # the lint is matrix-invariant
                except Exception:  # recorded; the run exits 1
                    traceback.print_exc()
                    print(f"ERROR: suite crashed on {t}/{ex} (see above)",
                          file=sys.stderr)
                    tool_error = True

    payload = {
        "reports": [r.to_dict() for r in reports],
        "total_findings": sum(len(r.findings) for r in reports),
        "ok": not tool_error and all(r.ok for r in reports),
    }
    payload["exit_code"] = (
        F.EXIT_ERROR if tool_error
        else F.EXIT_OK if payload["ok"] else F.EXIT_CONTRACT)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, default=str)
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
    else:
        for r in reports:
            print(r.format())
        print(f"\n{'OK' if payload['ok'] else 'CONTRACT VIOLATIONS'}: "
              f"{payload['total_findings']} finding(s) across "
              f"{len(reports)} run(s)")
    return payload["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
