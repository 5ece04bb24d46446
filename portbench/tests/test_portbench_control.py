"""The comparison fails what it must: the control (the plain reference in
bfloat16 put in the program's place) and the program with its timed path
broken underneath, in each cell at a small size on the CPU. The check of
the card is skipped; the rest of a run is driven as the benchmark drives it.
There is one card a cell, so no exchange between cards can be left out."""

import copy

import pytest
import torch
from small import small_files

from portbench.control import clone_volume, window_unchanged
from portbench.run import run_cell, verdict
from portbench.system import System

CELLS = ["bricks8.scan", "dense512.scan", "bricks8.view"]
FUSING = ["bricks8.scan", "dense512.scan"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    files = small_files(cell)
    result, _, ctrl = run_cell(files, 11, 0.3, False, "cpu", 0.0, control=True)
    assert result["correct"]
    correct, checked = verdict(ctrl, files["limits"]["limits"], False)
    assert not correct, checked


def _unchanged(monkeypatch):
    """Every fusion step does its work on a copy and returns the state as
    it was."""
    pass_ = System.fuse_pass

    def on_copy(self, d, p, c):
        scratch = copy.copy(self)
        scratch.vol = clone_volume(self.vol)
        pass_(scratch, d, p, c)

    monkeypatch.setattr(System, "fuse_pass", on_copy)


def _half_batch(monkeypatch):
    """Half of each batch left out: every other frame of a pass, the right
    half of each render."""
    pass_, render = System.fuse_pass, System.render

    def fuse_pass(self, d, p, c):
        pass_(self, d[::2], p[::2], c[::2])

    def rendered(self, pose, params):
        r = render(self, pose, params)
        r.points[:, r.points.shape[1] // 2:] = float("nan")
        return r

    monkeypatch.setattr(System, "fuse_pass", fuse_pass)
    monkeypatch.setattr(System, "render", rendered)


def _altered(monkeypatch):
    """An answer altered where it is produced: the fused sdf of the observed
    voxel nearest the surface, one rendered depth, each moved by a
    little."""
    pass_, render = System.fuse_pass, System.render

    def nudge(self):
        sdf = self.vol.sdf.view(-1)
        near = torch.argmin(torch.abs(sdf) + (self.vol.weight.view(-1) == 0) * 10.0)
        sdf[near] += 0.05

    def fuse_pass(self, d, p, c):
        pass_(self, d, p, c)
        nudge(self)

    def rendered(self, pose, params):
        r = render(self, pose, params)
        hit = torch.nonzero(~torch.isnan(r.depth))[0]
        r.points[hit[0], hit[1], 2] += 1e-3
        return r

    monkeypatch.setattr(System, "fuse_pass", fuse_pass)
    monkeypatch.setattr(System, "render", rendered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run_cell(small_files(cell), 13, 0.3, False, "cpu", 0.0)[0]
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("cell", FUSING)
def test_window_left_unfused_is_not_correct(cell, monkeypatch):
    """Set-up untouched, the window's fusion steps leave the state as set-up
    left it (control.py plants the same fault on the card)."""
    window_unchanged(monkeypatch.setattr)
    result = run_cell(small_files(cell), 17, 0.3, False, "cpu", 0.0)[0]
    assert not result["correct"], result["checked"]
    assert result["checked"]["count_mismatch"]["value"] > 0.5
