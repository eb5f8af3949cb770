"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's.

The reference's ``tests/test_dryrun_reduced.py`` compiles reduced
qwen2-1.5b ``train_4k`` and mamba2-780m ``decode_32k`` for its 256- and
512-device production meshes; all three of its cases fail under jax
0.9.0 (ROADMAP.md queue 3: ``jax.make_mesh``'s Explicit axes). The
twins here dry-run the same two combos on one device —
the port's step under a ``FakeTensorMode`` — and hold what is arithmetic
to the reference: the plan, the memory model's bytes at its micro size
and the step's argument bytes (the reference's abstract arguments). The
production-mesh dry run is ``tests/test_torch_gspmd.py``'s (train) and
``tests/test_torch_gspmd_serve.py``'s (prefill and decode).

The FLOPs are held to the closed form — 6 · (matmul params) · tokens
plus the chunked attention's QK and PV products, three times their
forward — within 0.5 % (they agree exactly; the tolerance is for a
future op FlopCounterMode counts that the closed form leaves out). A
full-width qwen2-1.5b ``train_4k`` dry run (18a's 4-layer cut) reports
a peak of hundreds of GiB while its process stays under 1.5 GiB
resident: nothing is allocated.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.analysis import hlo_checks as jhlo  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import findings as F  # noqa: E402
from repro_torch.engine import EXECUTORS, exec_core  # noqa: E402
from repro_torch.launch import dryrun, dryrun_all  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each executor's kernel-wrapper calls in a step of 4 micro-batches:
# K1 once a micro-batch where the executor fuses the accumulation, K2
# once a bucket where it fuses the update
KERNEL_CALLS = {"compiled": {}, "streaming": {}, "fused": {"grad_accum": 4},
                "flat": {"fused_sgd_mom": 1, "grad_accum": 4}}
FLOPS_RTOL = 5e-3
RSS_CAP_BYTES = 1.5 * 2 ** 30
# the dry run's main, then its own peak resident set: VmHWM, the high
# water mark of this process's address space (``ru_maxrss`` would also
# count the forking parent's, which exec folds into it)
MEASURED_MAIN = ("import sys\n"
                 "from repro_torch.launch import dryrun\n"
                 "rc = dryrun.main(sys.argv[1:])\n"
                 "hwm = [l for l in open('/proc/self/status')\n"
                 "       if l.startswith('VmHWM:')][0].split()[1]\n"
                 "print('MAXRSS', hwm)\n"
                 "sys.exit(rc)\n")


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", "train_4k"),
    ("mamba2-780m", "decode_32k"),
])
def test_reduced_dryrun_single_device(arch, shape):
    """The twin of ``test_reduced_dryrun_single_pod`` at one device."""
    res = dryrun.run_dryrun(arch, shape, reduced=True, device="cpu",
                            probe=False, verbose=False)
    assert res["num_devices"] == 1
    assert res["memory"]["temp_bytes"] >= 0
    assert res["raw_cost_analysis"]["flops"] > 0
    jcfg = jconfigs.get_reduced(arch)
    jshape = jconfigs.SHAPES[shape]
    jbundle = jsteps.build_step(jcfg, jshape, num_microbatches=8)
    # the step's arguments are the reference's abstract ones, byte for byte
    assert res["memory"]["argument_bytes"] == \
        jhlo.tree_bytes(jbundle.arg_shapes)
    if jshape.kind != "train":
        assert res["kind"] == jbundle.kind and res["num_microbatches"] is None
        return
    jplan = jengine.plan_mbs(jshape.global_batch, num_microbatches=8,
                             model_cfg=jcfg, seq_len=jshape.seq_len,
                             remat=True, remat_policy=None)
    assert (res["num_microbatches"], res["remat_policy"],
            res["per_device"]["local_micro"]) == \
        (jplan.num_micro_batches, jplan.remat_policy,
         jplan.micro_batch_size)
    kw = joptim.memory_model_kw(jsteps.make_optimizer(jcfg), fused=False)
    assert res["per_device"]["analytic_bytes_at_local_micro"] == \
        jmemory_model.estimate(jcfg, jshape.seq_len,
                               remat_policy=jplan.remat_policy,
                               **kw).total(jplan.micro_batch_size)


def _closed_form_flops(cfg, shape) -> int:
    """6 · matmul params · tokens + 3 × the chunked attention's forward
    (QK and PV: 4 · B · H · q · k · hd over every query chunk and the keys
    it reads, ``models.attention.chunked_attention``)."""
    from repro_torch.models import attention
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    per_layer = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * f
    tokens = shape.global_batch * shape.seq_len
    S, B = shape.seq_len, shape.global_batch
    qc = max(attention.Q_CHUNK, -(-S // 32))
    qc = -(-qc // 128) * 128
    chunks = [(c0, min(c0 + qc, S)) for c0 in range(0, S, qc)] \
        if S > attention.Q_CHUNK else [(0, S)]
    attn_fwd = sum(4 * B * H * (c1 - c0) * c1 * hd for c0, c1 in chunks)
    return (6 * tokens * (cfg.num_layers * per_layer + d * cfg.vocab_size)
            + 3 * cfg.num_layers * attn_fwd)


def test_flops_match_the_closed_form():
    """Reduced qwen2-1.5b ``train_4k`` without remat (a recomputed
    forward would add 2 · params · tokens): FlopCounterMode's count of
    the whole step against the closed form, and the period probes'
    FLOPs of one period in one micro-batch against the closed form's
    one layer at the plan's micro size."""
    res = dryrun.run_dryrun("qwen2-1.5b", "train_4k", reduced=True,
                            device="cpu", remat_policy="none",
                            verbose=False)
    cfg, shape = configs.get_reduced("qwen2-1.5b"), configs.SHAPES["train_4k"]
    want = _closed_form_flops(cfg, shape)
    got = res["raw_cost_analysis"]["flops"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
    assert cfg.pattern_len == 1
    micro = dataclasses.replace(
        shape, global_batch=res["per_device"]["local_micro"])
    want_period = (_closed_form_flops(dataclasses.replace(cfg, num_layers=2),
                                      micro)
                   - _closed_form_flops(dataclasses.replace(cfg,
                                                            num_layers=1),
                                        micro))
    got_period = res["corrected"]["flops_per_period"]
    assert abs(got_period - want_period) <= FLOPS_RTOL * want_period, \
        (got_period, want_period)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_micro_batch_extension_equals_the_unrolled_step(executor):
    """The default run (1 and 2 micro-batches, extended to N) reports the
    unrolled step's FLOPs, bytes, op count, kernel calls and peak, for
    every executor: its micro-batches repeat one another op for op."""
    kw = dict(reduced=True, device="cpu", probe=False, verbose=False,
              num_microbatches=4, executor=executor)
    ext = dryrun.run_dryrun("qwen2-1.5b", "train_4k", **kw)
    full = dryrun.run_dryrun("qwen2-1.5b", "train_4k", unrolled=True, **kw)
    assert (ext["micro_batches_run"], full["micro_batches_run"]) == (2, 4)
    assert ext["raw_cost_analysis"] == full["raw_cost_analysis"]
    assert ext["ops"] == full["ops"]
    assert abs(ext["memory"]["peak_bytes_est"]
               - full["memory"]["peak_bytes_est"]) <= 64
    assert ext["kernel_calls"] == full["kernel_calls"] == KERNEL_CALLS[
        executor]


def test_full_width_dryrun_allocates_nothing():
    """Full-width qwen2-1.5b ``train_4k`` (4 of 28 layers, 18a's cut; the
    plan at 8 micro-batches of 32 × 4096 tokens): the step's peak is
    hundreds of GiB, the process's resident set stays under
    ``RSS_CAP_BYTES``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", MEASURED_MAIN, "--arch", "qwen2-1.5b",
         "--shape", "train_4k", "--layers", "4", "--device", "cpu",
         "--executor", "flat", "--no-probe"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    rss = int(lines[-1].split()[1]) * 1024  # VmHWM is in KiB
    res = json.loads(lines[-2])
    assert res["memory"]["peak_bytes_est"] > 100 * 2 ** 30
    assert res["memory"]["argument_bytes"] > 3 * 2 ** 30
    assert rss < RSS_CAP_BYTES, rss


def test_exit_codes(monkeypatch, capsys):
    """0 clean, 2 over ``--budget``, 3 with ``--check`` on a seeded fault
    (an executor that accumulates in bf16 under an fp32 plan: JX001); 0
    for a serving shape on either production mesh, which runs as one
    rank there. (64 micro-batches of 4: at 8 of 32 the eager step's peak
    is 32x the memory model's, and HLO003 fires on the clean step.)"""
    base = ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--reduced",
            "--device", "cpu", "--no-probe", "--microbatches", "64"]
    assert dryrun.main(base + ["--check"]) == F.EXIT_OK
    capsys.readouterr()
    assert dryrun.main(base + ["--budget", "0.001"]) == F.EXIT_BUDGET
    assert "BUDGET EXCEEDED" in capsys.readouterr().err

    real = exec_core.init_accum
    monkeypatch.setattr(exec_core, "init_accum",
                        lambda params, dtype: real(params, torch.bfloat16))
    assert dryrun.main(base + ["--check"]) == F.EXIT_CONTRACT
    assert "CONTRACT: [JX001]" in capsys.readouterr().err
    monkeypatch.undo()

    serve = ["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--reduced",
             "--device", "cpu", "--no-probe"]
    for extra, world in ((["--multi-pod"], 512),
                         (["--mesh", "production"], 256)):
        assert dryrun.main(serve + extra) == F.EXIT_OK
        assert f'"num_devices": {world}' in capsys.readouterr().out


def test_check_at_8_micro_batches_pins_the_memory_model_gap(capsys):
    """The known gap (ROADMAP.md, "The memory model counts XLA's
    activations, not eager PyTorch's"): at the default 8 micro-batches of
    32, ``--check`` on the clean step fires HLO003 and nothing else — the
    eager step's peak is beyond the 16x band of the memory model's bytes.
    A change to the model or to the step's peak shows here."""
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                        "--reduced", "--device", "cpu", "--no-probe",
                        "--check"]) == F.EXIT_CONTRACT
    rules = {line.split("]")[0].split("[")[1]
             for line in capsys.readouterr().err.splitlines()
             if line.startswith("CONTRACT: [")}
    assert rules == {"HLO003"}


def test_mesh_spec_reports_the_closed_form_census():
    res = dryrun.run_dryrun("qwen2-1.5b", "train_4k", reduced=True,
                            device="cpu", probe=False, verbose=False,
                            mesh_spec="1:2")
    pipe = res["pipeline"]
    assert pipe["stages"] == 2 and pipe["ticks"] == 2 * (
        pipe["num_micro_batches"] + 1)
    assert pipe["expected_collectives"]["all_reduce_data_model"] == 1
    assert pipe["expected_collectives"]["p2p_by_stage"][0]["fwd_send"] == \
        pipe["num_micro_batches"]


def test_dryrun_all_skips_and_refuses(tmp_path):
    """The matrix runner: an unassigned combo is skipped without a
    subprocess; a serving shape of the multi-pod column runs as one rank
    of the 2 × 16 × 16 mesh (run here as ``run_one``'s subprocess would
    run it) and its row prints its peak — no combo is refused."""
    skip = dryrun_all.run_one("qwen2-1.5b", "long_500k", "single",
                              str(tmp_path))
    assert skip["skipped"]
    multi = dryrun.run_dryrun("qwen2-1.5b", "decode_32k", multi_pod=True,
                              reduced=True, device="cpu", probe=False,
                              verbose=False)
    assert multi["kind"] == "decode" and multi["num_devices"] == 512
    assert len(list(dryrun_all.combos())) == 2 * len(configs.ARCHS) * len(
        configs.SHAPES)
    # a combo's file is read back, not run again
    assert dryrun_all.run_one("qwen2-1.5b", "long_500k", "single",
                              str(tmp_path)) == skip
    line = dryrun_all.summary_line(multi)
    assert " peak " in line and "GiB" in line and "decode" in line
    assert "refused" not in line
    res = dryrun.run_dryrun("qwen2-1.5b", "train_4k", reduced=True,
                            device="cpu", probe=False, verbose=False,
                            num_microbatches=64)
    line = dryrun_all.summary_line(res)
    assert "64 x micro 4 period" in line and line.endswith("fits 80 GB")
