"""A whole run of each kind of cell at a tiny size on the CPU (the
harness's look for a card skipped) comes out correct, and so does its
traced form."""
import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("name", [tiny.SERVE, tiny.DOCQA,
                                  tiny.DENSE_TRAIN])
def test_a_sound_run_is_correct(name):
    line = tiny.run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in tiny.cell(name)["end_to_end"]}
    assert set(line["metrics"]) == e2e
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", [tiny.SERVE, tiny.DENSE_TRAIN])
def test_a_traced_run_is_correct(name):
    line = tiny.run(name, trace=True)
    assert line["correct"], line["checks"]
    assert "breakdown" in line and line["device"]["window_s"] > 0
