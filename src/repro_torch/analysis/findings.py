"""Structured findings, the rule registry and the process exit-code
contract — the reference's ``analysis/findings.py``, with the same rule
ids, so that both packages report one fault under one id.

Every analyzer layer (the recorded step trace, the measured step, the AST
lint) reports violations as :class:`Finding`s — severity, stable rule id,
human location, and a machine-readable ``details`` dict — collected into
a :class:`Report` that renders as text or JSON and maps onto the
repo-wide exit-code contract (shared with ``launch/dryrun.py``):

  * ``EXIT_OK`` (0)       — clean run, no findings.
  * ``EXIT_ERROR`` (1)    — the tool itself failed (bad config, crash).
  * ``EXIT_BUDGET`` (2)   — dry-run memory-budget overrun.
  * ``EXIT_CONTRACT`` (3) — one or more contract findings.

(Argparse usage errors also exit 2 by Python convention.)

A rule's ``layer`` says what the port inspects: ``trace`` — the recorded
op trace of one step (``engine.steptrace.record``, the reference's
jaxpr); ``step`` — one real step's storages, collectives and peak
(``engine.steptrace.measure``, the reference's compiled HLO); ``ast`` —
the source. Intentional violations are waived inline with
``# repro: noqa(RULE)``: on the statement for an AST rule, on the line
that makes the host read for JX003.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_BUDGET = 2
EXIT_CONTRACT = 3

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

#: rule id -> (layer, one-line contract) — the single source of truth the
#: CLI and docs enumerate. A Finding of an unregistered rule raises.
RULES: Dict[str, Dict[str, str]] = {
    "JX001": {"layer": "trace",
              "contract": "micro-gradients accumulate in the plan's "
                          "accum_dtype (fp32 by default): every in-place "
                          "add into an accumulator and every K1 call"},
    "JX002": {"layer": "trace",
              "contract": "the remat policy the planner chose is applied "
                          "to the step: checkpoint regions and their "
                          "recomputation where models/remat.py puts them "
                          "(none / dots / period / full)"},
    "JX003": {"layer": "trace",
              "contract": "no read of a device value by the host "
                          "(.item(), nonzero, a device-to-host copy; on "
                          "the card every synchronizing call) inside the "
                          "step"},
    "JX004": {"layer": "trace",
              "contract": "collective census: exactly one gradient "
                          "all-reduce per mini-batch when deferred, >= "
                          "N_Smu otherwise, no collective without a mesh; "
                          "on a GSPMD rank, collectives over the mesh's "
                          "axes only and the gradients reduce-scattered "
                          "over the batch axes"},
    "JX005": {"layer": "trace",
              "contract": "pipelined (1F1B) census: the point-to-point "
                          "calls match the closed-form schedule exactly "
                          "(engine.p2p_counts); deferred sync keeps ONE "
                          "data-axis gradient all-reduce per mini-batch "
                          "(none on a data axis of one rank) plus ONE "
                          "(data+model) all-reduce for the shared grads, "
                          "loss and metrics; the per-micro baseline "
                          "issues >= N_Smu data-axis all-reduces"},
    "HLO001": {"layer": "step",
               "contract": "an executor that updates in place keeps every "
                           "param, optimizer-state and flat-buffer storage "
                           "across a step, and adds every micro-batch "
                           "into the same accumulator storage"},
    "HLO002": {"layer": "step",
               "contract": "no all-gather in a replicated-state (non-FSDP) "
                           "step"},
    "HLO003": {"layer": "step",
               "contract": "the step's peak bytes agree with "
                           "core/memory_model within the declared "
                           "tolerance"},
    "HLO004": {"layer": "step",
               "contract": "the step's collective schedule: one "
                           "all-reduce per mini-batch (deferred) / >= "
                           "N_Smu (per-micro baseline), none without a "
                           "mesh"},
    "HLO005": {"layer": "step",
               "contract": "the pipelined step's schedule: exactly the "
                           "data-axis and (data+model) non-scalar "
                           "all-reduces when deferred, >= N_Smu when "
                           "per-micro; point-to-point calls bounded by "
                           "the schedule's census"},
    "LINT001": {"layer": "ast",
                "contract": "no .item()/float()/.cpu()/.tolist()/"
                            "torch.cuda.synchronize host syncs in engine "
                            "hot-loop modules"},
    "LINT002": {"layer": "ast",
                "contract": "no F.pad / np.pad in kernels/ (the no-copy "
                            "rule)"},
    "LINT003": {"layer": "ast",
                "contract": "an in-place write to a serving pool or cache "
                            "in engine/ reads the donate flag (the "
                            "donate=False opt-out)"},
    "LINT004": {"layer": "ast",
                "contract": "every kernel launch sits in a wrapper in "
                            "kernels/ whose module has a plain twin in "
                            "kernels/ref.py, and no try/except wraps a "
                            "launch (no silent fallback to the plain "
                            "version)"},
    "LINT005": {"layer": "ast",
                "contract": "production code imports kernels through the "
                            "repro_torch.kernels public surface, not deep "
                            "submodule paths"},
    "LINT006": {"layer": "ast",
                "contract": "bare except Exception in src/repro_torch/"
                            "engine/ routes through the supervisor's fault "
                            "taxonomy (faults.is_oom/...) or carries "
                            "# repro: noqa"},
    "SRV001": {"layer": "step",
               "contract": "with donation, a decode step writes the KV "
                           "pool in place: every pool leaf keeps its "
                           "storage (a non-donated pool keeps two KV "
                           "copies live)"},
    "SRV002": {"layer": "step",
               "contract": "the decode step's peak agrees with "
                           "core/memory_model.serve_estimate within the "
                           "declared band AND stays under the budget the "
                           "ServePlan was admitted against"},
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation (or advisory)."""
    rule: str
    severity: str
    message: str
    location: str = ""  # file:line for AST rules and host reads
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unregistered rule id {self.rule!r}; "
                             f"known: {sorted(RULES)}")
        if self.severity not in (SEVERITY_ERROR, SEVERITY_WARNING):
            raise ValueError(f"bad severity {self.severity!r}")

    def format(self) -> str:
        loc = f" @ {self.location}" if self.location else ""
        return f"[{self.rule}:{self.severity}]{loc} {self.message}"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """Findings from one analysis run + the context it ran under."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    context: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks_run: List[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_WARNING]

    @property
    def ok(self) -> bool:
        """True only when there are NO findings at all — the gate is
        strict (warnings fail too; waive intentional ones at the source)."""
        return not self.findings

    def exit_code(self) -> int:
        return EXIT_OK if self.ok else EXIT_CONTRACT

    def extend(self, findings: Iterable[Finding], check: Optional[str] = None
               ) -> "Report":
        self.findings.extend(findings)
        if check is not None and check not in self.checks_run:
            self.checks_run.append(check)
        return self

    def merge(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        for c in other.checks_run:
            if c not in self.checks_run:
                self.checks_run.append(c)
        for k, v in other.context.items():
            self.context.setdefault(k, v)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "exit_code": self.exit_code(),
            "context": self.context,
            "checks_run": list(self.checks_run),
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def format(self) -> str:
        head = ", ".join(f"{k}={v}" for k, v in self.context.items())
        lines = [f"analysis [{head}]" if head else "analysis",
                 f"  checks: {', '.join(self.checks_run) or '(none)'}"]
        if self.ok:
            lines.append("  OK — zero findings")
        else:
            lines.append(f"  {len(self.errors)} error(s), "
                         f"{len(self.warnings)} warning(s):")
            lines += [f"  {f.format()}" for f in self.findings]
        return "\n".join(lines)
