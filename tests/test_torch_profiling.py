"""ccvpe_torch.utils.profiling: ``StepTimer`` summarises as the JAX
package's does, and ``trace`` writes a Chrome trace that holds an
``annotate`` range and the ops run inside it."""

import json

import pytest
import torch

from ccvpe_tpu.utils import profiling as JP
from ccvpe_torch.utils import profiling as TP


@pytest.mark.parametrize("durations", [[], [0.5], [0.3, 0.1, 0.2, 0.4, 0.25]])
def test_step_timer_summary_matches_jax(durations):
    got, want = TP.StepTimer(), JP.StepTimer()
    got._durations, want._durations = list(durations), list(durations)
    assert got.summary() == want.summary()
    assert got.summary(skip_first=0) == want.summary(skip_first=0)
    timer = TP.StepTimer()
    with timer.step():
        pass
    timer.stop()                     # a stop without a start adds nothing
    assert timer.summary()["steps"] == 1


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    with TP.trace(str(tmp_path / "prof")):
        with TP.annotate("ccvpe.step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.loads((tmp_path / "prof" / TP.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ccvpe.step" in names and any("mm" in str(n) for n in names)
