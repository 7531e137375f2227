"""The tracer's checks (``benchmark/tools/trace_check.py``) pass on a
traced run: at the CPU size here, and on the card at a cell's size and
length with ``-m cuda`` (where the synchronizing calls are counted and
compared with the profile's)."""

import json

import pytest

from benchmark.core import spec
from benchmark.tools import trace_check

D = "oak4-640x400-deployed.cadence30-map"
F = "oak4-1280x720-flagship.replay-vo"


def _lines(capsys) -> dict:
    return {d["tag"]: d for d in map(json.loads, capsys.readouterr().out.splitlines()) if d}


def test_check_passes_on_the_cpu(capsys):
    rc = trace_check.main(["check", D, "3000000123", "--seconds", "4", "--small"])
    out = _lines(capsys)
    assert rc == 0 and out["verdicts"]["all"], out["verdicts"]
    ticks = out["self_ms_per_tick"]
    assert ticks["sum_ms"] == pytest.approx(ticks["root_ms"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [D, F])
def test_check_passes_on_the_card(cuda_device, capsys, name):
    """A traced run as the benchmark makes it, ``run_seconds`` long."""
    seconds = str(spec.load_benchmark()["run_seconds"])
    rc = trace_check.main(["check", name, "3000000321", "--seconds", seconds])
    out = _lines(capsys)
    assert rc == 0 and out["verdicts"]["all"], out["verdicts"]
    assert out["syncs"]["traced_ticks_profile"] > 0 and sum(out["syncs"]["tracer_syncs_per_tick"]) > 0
