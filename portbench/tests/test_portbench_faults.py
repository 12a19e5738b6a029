"""Whole runs of each driver at test size on the CPU, past the harness's
look for a card: sound, they come out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (an answer altered where it is produced; a step that leaves its state
unchanged; half of the batch left out, the mean taken over the rest).
A cell on one chip has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from portbench.tests import portbench_cells as cells


def _altered_readout(monkeypatch):
    """Every pose's row moved by half the map: an answer altered where the
    program produces it (``ops.readout.pose_readout``)."""
    from ccvpe_torch.ops import readout

    real = readout.pose_readout

    def altered(out, want_heatmap=False):
        r = real(out, want_heatmap)
        h = out.heatmap.shape[1]
        return {**r, "row": (r["row"] + h // 2) % h}

    monkeypatch.setattr(readout, "pose_readout", altered)


@pytest.mark.parametrize("cell", ["vigor-infer-b8", "kitti-infer-b8"])
def test_infer_sound_and_altered(cell, monkeypatch):
    result, lines = cells.run(cells.nano_cell(cell), seconds=6, trace=True)
    assert result["correct"] and result["attempted"] > 0 and len(lines) == 2, lines
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    assert list(result)[-1] == "checks"
    _altered_readout(monkeypatch)
    result, _ = cells.run(cells.nano_cell(cell))
    assert not result["correct"] and result["checks"]["prob_rel"]["value"] > 1e-2
    assert set(result["metrics"]) == {"pairs_per_s", "setup_s"}


def _broken_step(monkeypatch, fault: str):
    from ccvpe_torch.train import loop

    real = loop.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, batch, generator=None):
            if fault == "half_batch":
                half = batch["gt"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()}, generator)
            before = [p.detach().clone() for p in state.model.parameters()]
            parts = step(state, batch, generator)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return parts

        return broken

    monkeypatch.setattr(loop, "make_train_step", make)


def test_train_sound():
    result, lines = cells.run(cells.nano_cell("vigor-train-b8"), seconds=6, trace=True)
    assert result["correct"] and len(lines) == 3
    assert "train.mfu_pct" in result["metrics"]


@pytest.mark.parametrize("fault,number", [("unchanged_state", "change_norm_gap"),
                                          ("half_batch", "loss_rel")])
def test_train_faults(fault, number, monkeypatch):
    _broken_step(monkeypatch, fault)
    result, _ = cells.run(cells.nano_cell("vigor-train-b8"), seconds=1)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"]
