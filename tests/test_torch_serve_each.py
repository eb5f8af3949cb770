"""The GSPMD serve conformance harness keeps each world call's outcome
apart (``torch_gspmd_serve_cases.serve_each``): a call that fails — on a
rank, or in the reference run beside it — is recorded under its own key
and closes its world, and the calls after it run on a new world, so one
arch's failure fails only the tests that read that arch. Two gloo CPU
ranks, ``launch.world.LocalWorld``."""
import pytest

import torch_gspmd_serve_cases as cases
from repro_torch.launch.world import LocalWorld


def _reference_fails():
    raise ArithmeticError("the reference fails here")


@pytest.mark.parametrize("where", ["rank", "reference"])
def test_a_failed_call_fails_only_its_own_key(tmp_path, where):
    worlds = []

    def start():
        worlds.append(LocalWorld(2, store_dir=str(tmp_path), timeout_s=120))
        return worlds[-1]

    bad = ((cases.fail_on_rank, (1,), None) if where == "rank"
           else (cases.rank_times, (3,), _reference_fails))
    out = cases.serve_each(start, [
        ("a", lambda: (cases.rank_times, (10,), lambda: "reference a")),
        ("b", lambda: bad),
        ("c", lambda: (cases.rank_times, (20,), None))])
    assert out["a"] == ([0, 10], "reference a")
    if where == "rank":
        assert isinstance(out["b"], RuntimeError)
        assert "rank 1 failed" in str(out["b"])
        assert "rank 1 fails here" in str(out["b"])
    else:
        assert isinstance(out["b"], ArithmeticError)
    assert out["c"] == ([0, 20], None)
    # the failed call closed its world; the next ran on a new one, closed
    # at the end: both refuse a further call
    assert len(worlds) == 2
    for w in worlds:
        with pytest.raises(RuntimeError, match="local world is broken"):
            w.run(cases.rank_times, 1)
