"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` loads neither JAX nor the JAX package, the launchers, the
contract checker and the dry run run on the CPU when asked, and without
a GPU the CUDA entry points fail loudly instead of running somewhere
else."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the twins of the reference's examples/ (repro_torch.examples)
EXAMPLES = ("quickstart", "serve_decode", "train_100m", "train_classifier",
            "train_segmentation")
TRAIN = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--reduced", "--steps", "2", "--executor", "flat"]
SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--reduced", "--requests", "4", "--new-tokens", "3"]

IMPORT_ALL = """
import contextlib, importlib, io, pkgutil, sys
import repro_torch
said = io.StringIO()
with contextlib.redirect_stdout(said):
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    import chip_smoke
for name in ("repro_torch.engine.pipelined", "repro_torch.analysis.suite",
             "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_all",
             "repro_torch.engine.gspmd", "repro_torch.launch.sharding",
             *("repro_torch.examples." + e for e in EXAMPLES)):
    assert name in sys.modules, name
bad = sorted(k for k in sys.modules
             if k.startswith("jax") or k == "repro" or k.startswith("repro."))
print("LEAKED", bad, "PRINTED", repr(said.getvalue()))
"""


BUILD_ALL = """
import sys
from repro_torch import configs, tree
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import steps
n = 0
for arch in configs.ARCHS:
    for shape in SHAPES.values():
        b = steps.build_step(configs.get(arch), shape, budget_bytes=16 << 30,
                             device="cpu")
        assert all(x.device.type == "meta" for x in tree.leaves(b.arg_shapes))
        n += 1
bad = sorted(k for k in sys.modules
             if k.startswith("jax") or k == "repro" or k.startswith("repro."))
print("BUILT", n, "LEAKED", bad)
"""


CHECK_AND_DRYRUN = """
import sys
from repro_torch.analysis import __main__ as cli
from repro_torch.launch import dryrun
assert cli.main(["--device", "cpu", "--config", "qwen2_reduced",
                 "--executor", "flat"]) == 0
assert cli.main(["--device", "cpu", "--serve"]) == 0
assert cli.main(["--device", "cpu", "--serve", "--mesh", "2:1"]) == 0
assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                    "--reduced", "--device", "cpu", "--no-probe"]) == 0
assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                    "--reduced", "--device", "cpu", "--no-probe",
                    "--mesh", "production"]) == 0
bad = sorted(k for k in sys.modules
             if k.startswith("jax") or k == "repro" or k.startswith("repro."))
print("LEAKED", bad)
"""
ANALYSIS = [sys.executable, "-m", "repro_torch.analysis", "--config",
            "qwen2_reduced"]
DRYRUN = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          "qwen2-1.5b", "--shape", "decode_32k", "--reduced", "--no-probe"]


def _run(cmd, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the examples' twins among them, and
    ``chip_smoke`` import without JAX, and importing runs nothing (the
    twins print nothing until their ``main`` is called)."""
    out = _run([sys.executable, "-c",
                f"EXAMPLES = {EXAMPLES!r}\n" + IMPORT_ALL])
    assert out.returncode == 0, out.stderr
    assert "LEAKED [] PRINTED ''" in out.stdout, out.stdout


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_without_gpu_fails_clearly(example):
    """Each twin runs on the card unless ``--device cpu`` is given:
    without a GPU it exits non-zero, naming it, before it prints."""
    _no_gpu()
    out = _run([sys.executable, "-m", f"repro_torch.examples.{example}"])
    assert out.returncode != 0
    assert "no CUDA GPU is available" in out.stderr, out.stderr[-2000:]
    assert out.stdout == ""


def test_step_builders_build_every_bundle_without_jax():
    """``configs/shapes.py`` and the step builders: every architecture ×
    assigned shape builds its bundle from meta tensors, loading neither
    JAX nor the JAX package."""
    out = _run([sys.executable, "-c", BUILD_ALL])
    assert out.returncode == 0, out.stderr
    assert "BUILT 40 LEAKED []" in out.stdout, out.stdout


def test_spawned_ranks_import_neither_jax_nor_the_jax_package(tmp_path):
    """The data-parallel ranks of a ``LocalWorld`` are spawned, so this
    process's JAX does not reach them, and the port's sharded modules
    load none."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_cases
    import torch_pipeline_cases
    from repro_torch.launch.world import LocalWorld
    with LocalWorld(2, store_dir=str(tmp_path), timeout_s=120) as world:
        assert world.run(torch_mesh_cases.leaked_modules) == [[], []]
        # the pipelined executor's cases, a 1 x 2 pipeline mesh built
        assert world.run(torch_pipeline_cases.leaked_modules) == [[], []]


def test_launcher_runs_on_cpu_when_asked():
    out = _run(TRAIN + ["--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert "MBSPlan: mini-batch 16" in out.stdout
    assert "step    1  loss" in out.stdout


def test_launcher_without_gpu_fails_clearly():
    _no_gpu()
    out = _run(TRAIN)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "step" not in out.stdout


def test_serve_launcher_runs_on_cpu_when_asked():
    out = _run(SERVE + ["--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert "ServePlan: 256 decode slots @ max_len 128" in out.stdout
    assert "4/4 requests finished" in out.stdout


def test_serve_launcher_without_gpu_fails_clearly():
    _no_gpu()
    out = _run(SERVE)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "ServePlan" not in out.stdout


def test_checker_and_dryrun_run_on_cpu_when_asked():
    """``python -m repro_torch.analysis`` and the dry run on the CPU:
    clean, and loading no JAX."""
    out = _run([sys.executable, "-c", CHECK_AND_DRYRUN])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout, out.stdout[-2000:]
    assert "OK: 0 finding(s)" in out.stdout


def test_checker_and_dryrun_without_gpu_fail_clearly(tmp_path):
    """Their default device is the card: without one they refuse (the
    lint alone runs no step and needs none); ``dryrun_all`` records each
    combo's refusal."""
    _no_gpu()
    for cmd in (ANALYSIS, DRYRUN):
        out = _run(cmd)
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
        assert '"arch"' not in out.stdout and "OK:" not in out.stdout
    assert _run(ANALYSIS[:3] + ["--lint-only"]).returncode == 0
    out = _run([sys.executable, "-m", "repro_torch.launch.dryrun_all",
                "--out", str(tmp_path), "--only-arch", "qwen2-1.5b",
                "--only-shape", "decode_32k", "--only-mesh", "single"])
    assert out.returncode != 0 and "FAIL" in out.stdout
    with open(tmp_path / "qwen2-1.5b__decode_32k__single.json") as f:
        assert "no CUDA device is available" in f.read()


def test_chip_smoke_without_gpu_fails_and_prints_no_result(tmp_path):
    _no_gpu()
    out = _run([sys.executable, "chip_smoke.py"])
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stderr
    assert '"ok"' not in out.stdout
    # alone in a directory, without the repository, it fails too
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
