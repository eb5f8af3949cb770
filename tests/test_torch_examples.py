"""The port's twins of the reference's ``examples/`` scripts
(``repro_torch.examples``), each held against the reference script itself,
run in this process on the CPU with its output captured.

The reference's initial weights are built as the script builds them
(``PRNGKey(0)``; the serving prompts from ``PRNGKey(1)``), carried across
by ``weights.from_reference`` and handed to the twin's ``main``, which runs
with ``--device cpu``. Every number the reference prints (but times) must
be within half a unit of its last printed digit, plus 1e-5, of the twin's
unrounded value; token ids, "Failed" lines and plan descriptions must be
equal.
"""
import contextlib
import functools
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.examples import (quickstart, serve_decode,  # noqa: E402
                                  train_100m, train_classifier,
                                  train_segmentation)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
CPU = ["--device", "cpu"]
# the reference plans train_100m against a TPU v5e's 16 GiB
V5E_GB = ["--hbm-budget-gb", "16"]
NUM = r"(-?\d+\.\d+)"


def _reference(name: str, argv, run: bool = True):
    """``examples/<name>.py`` run here as a script with ``argv``: its
    stdout (or, with ``run=False``, its globals, ``main`` not called)."""
    path = os.path.join(EXAMPLES, name + ".py")
    if not run:
        return runpy.run_path(path, run_name="reference_" + name)
    said, argv0 = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(said):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv0
    return said.getvalue()


def _near(printed: str, value: float, what: str) -> None:
    """``value`` within half a unit of ``printed``'s last digit + 1e-5."""
    tol = 0.5 * 10.0 ** -len(printed.split(".")[1]) + 1e-5
    assert abs(float(printed) - value) <= tol, (what, printed, value)


def _port(tree_):
    return weights.from_reference(jax.tree.map(np.asarray, tree_), "cpu")


@functools.lru_cache(maxsize=None)
def _lm_params(arch: str):
    return jtransformer.init_params(jconfigs.get_reduced(arch),
                                    jax.random.PRNGKey(0))


def test_quickstart_twin_prints_the_reference_losses():
    ref = _reference("quickstart", [])
    rows = re.findall(rf"step\s+(\d+)\s+loss {NUM}\s+\|grad\| {NUM}", ref)
    assert len(rows) == 5 and "done" in ref
    got = quickstart.main(CPU, params=_port(_lm_params("qwen2-1.5b")))
    assert sorted(got) == [int(s) for s, _, _ in rows]
    for step, loss, norm in rows:
        _near(loss, got[int(step)][0], f"step {step} loss")
        _near(norm, got[int(step)][1], f"step {step} |grad|")


def test_serve_decode_twin_generates_the_reference_tokens():
    ref = _reference("serve_decode", [])
    shape = tuple(int(x) for x in re.search(
        r"generated shape \((\d+), (\d+)\)", ref).groups())
    first = [int(x) for x in re.search(r"first sequence: \[([\d, ]+)\]",
                                       ref).group(1).split(",")]
    cfg = jconfigs.get_reduced("gemma2-9b")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 24),
                                            0, cfg.vocab_size))
    gen = serve_decode.main(CPU, params=_port(_lm_params("gemma2-9b")),
                            prompts=torch.from_numpy(prompts))
    assert tuple(gen.shape) == shape
    assert gen[0].tolist() == first


def _small_params():
    cfg = _reference("train_100m", [], run=False)["model_small"]()
    return _port(jtransformer.init_params(cfg, jax.random.PRNGKey(0)))


def test_train_100m_twin_prints_the_reference_plan_and_losses(tmp_path):
    """``--steps 3`` into a fresh checkpoint directory each: the model
    line, the plan (the reference's 16 GiB budget), the Trainer's logged
    losses and gradient norms."""
    ref = _reference("train_100m", ["--steps", "3", "--ckpt-dir",
                                    str(tmp_path / "reference")])
    got = train_100m.main(CPU + V5E_GB + ["--steps", "3", "--ckpt-dir",
                                          str(tmp_path / "port")],
                          params=_small_params())
    name, m, seq, mini = re.search(
        r"model (\S+): ([\d.]+)M params, seq (\d+), mini-batch (\d+)",
        ref).groups()
    cfg = got["config"]
    assert (name, int(seq), int(mini)) == (cfg.name, 64, 32)
    _near(m, cfg.param_count() / 1e6, "params (M)")
    plan = next(ln for ln in ref.splitlines() if ln.startswith("MBSPlan"))
    assert plan == got["plan"].describe()
    assert got["start"] == 0 and "restored" not in ref
    rows = re.findall(rf"step\s+(\d+)\s+loss {NUM}\s+\|g\| {NUM}", ref)
    assert [int(s) for s, _, _ in rows] == [0, 2]
    hist = {h["step"]: h for h in got["history"]}
    for step, loss, norm in rows:
        _near(loss, hist[int(step)]["loss"], f"step {step} loss")
        _near(norm, hist[int(step)]["grad_norm"], f"step {step} |g|")


def test_train_100m_twin_resumes_bit_for_bit(tmp_path):
    """``--steps 3`` then ``--steps 5`` from the same checkpoint directory
    (``flat``: K1 and K2's plain versions on the CPU) give the losses of
    a straight 5-step run bit for bit, the second run saying so."""
    argv = CPU + V5E_GB + ["--executor", "flat"]
    params = _small_params()
    straight = train_100m.main(argv + ["--steps", "5", "--ckpt-dir",
                                       str(tmp_path / "straight")],
                               params=params)
    ck = str(tmp_path / "resumed")
    first = train_100m.main(argv + ["--steps", "3", "--ckpt-dir", ck],
                            params=params)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        second = train_100m.main(argv + ["--steps", "5", "--ckpt-dir", ck],
                                 params=params)
    assert "restored checkpoint at step 3" in said.getvalue()
    assert second["start"] == 3
    resumed = first["history"] + second["history"]
    assert [h["step"] for h in resumed] == list(range(5))
    assert [h["loss"] for h in resumed] == [
        h["loss"] for h in straight["history"]]


@pytest.mark.parametrize("no_mbs", [False, True])
def test_train_classifier_twin_prints_the_reference_rows(no_mbs):
    """Batches 16 and 32 for 2 steps each, with MBS and without (where 32
    is over the simulated cap): the "Failed" lines, accuracy and loss."""
    argv = ["--batches", "16", "32", "--steps", "2"] + (
        ["--no-mbs"] if no_mbs else [])
    ref = _reference("train_classifier", argv)
    p, s = jcnn.resnet_init(jax.random.PRNGKey(0), num_classes=8,
                            stage_sizes=(1, 1), width=8)
    got = train_classifier.main(CPU + argv, params=(_port(p), _port(s)))
    failed = [int(b) for b in re.findall(r"batch\s+(\d+)\s+w/o MBS: Failed",
                                         ref)]
    assert failed == ([32] if no_mbs else [])
    assert [b for b, r in got.items() if r == "Failed"] == failed
    rows = re.findall(rf"batch\s+(\d+)\s+(w/ MBS \(mu=\d+\)|w/o MBS)\s+"
                      rf"acc {NUM}\s+loss {NUM}", ref)
    assert [int(b) for b, *_ in rows] == ([16] if no_mbs else [16, 32])
    for batch, mode, acc, loss in rows:
        assert mode == ("w/o MBS" if no_mbs else "w/ MBS (mu=8)")
        _near(acc, got[int(batch)]["acc"], f"batch {batch} acc")
        _near(loss, got[int(batch)]["loss"], f"batch {batch} loss")


def test_train_segmentation_twin_prints_the_reference_loss_and_iou():
    ref = _reference("train_segmentation", ["--steps", "2"])
    p, s = jcnn.unet_init(jax.random.PRNGKey(0), base=8, depth=2)
    got = train_segmentation.main(CPU + ["--steps", "2"],
                                  params=(_port(p), _port(s)))
    rows = re.findall(rf"step\s+(\d+)\s+loss {NUM}", ref)
    assert [int(st) for st, _ in rows] == sorted(got["losses"]) == [0]
    for step, loss in rows:
        _near(loss, got["losses"][int(step)], f"step {step} loss")
    iou = re.search(rf"IoU {NUM}\s+\(.*mini-batch (\d+), micro (\d+)\)",
                    ref)
    assert iou.group(2, 3) == ("32", "4")
    _near(iou.group(1), got["iou"], "IoU")
