"""The frozen reference against the program at tiny sizes on the CPU, and the
comparison failing the faults a run can have.

Each case rehearses a whole cell with ``--dry-run`` (the cell's files'
``dry_run`` sizes): the program's packed run, the window, and the reference
over the sample of completed videos, as on the card."""

import dataclasses

import numpy as np
import pytest

from benchmark.harness.cell import Options, forbidden_modules, run_cell

CELLS = ("i3d_pwc.kinetics_packed", "raft.ssv2_packed")


def _run(workload, seed=11, hook=None, trace=False):
    return run_cell(Options(workload=workload, seed=seed, seconds=6, trace=trace,
                            dry_run=True, program_hook=hook))


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(workload, tmp_env):
    result = _run(workload)
    assert result["correct"] is True, result["checks"]
    assert result["window"]["checked_videos"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert forbidden_modules() == []


def _finalize_fault(change):
    """Plant ``change(out)`` into the program's per-video finalize."""
    def hook(ex):
        make = ex.pack_spec

        def pack_spec():
            spec = make()
            fin = spec.finalize

            def finalize(path, rows, info):
                return change(fin(path, rows, info))
            return dataclasses.replace(spec, finalize=finalize)
        ex.pack_spec = pack_spec
    return hook


def _alter_answer(out):
    key = "raft" if "raft" in out else "flow"
    out[key] = np.array(out[key], copy=True)
    out[key][0] += 0.05 * np.abs(out[key]).max()
    return out


def _reverse_rows(out):
    return {k: (v[::-1].copy() if k in ("rgb", "flow", "raft") else v) for k, v in out.items()}


def _half_batch(ex):
    """Half of every device batch's rows left out (zeroed) where the step
    produces them."""
    name = "_device_flow" if hasattr(ex, "_device_flow") else "_composite_forward"
    step = getattr(ex, name)

    def broken(*a, **kw):
        out = step(*a, **kw).clone()
        out[out.shape[0] // 2:] = 0
        return out
    setattr(ex, name, broken)


FAULTS = {"answer_altered": _finalize_fault(_alter_answer),
          "rows_out_of_order": _finalize_fault(_reverse_rows),
          "half_batch_left_out": _half_batch}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_incorrect(workload, fault, tmp_env):
    result = _run(workload, hook=FAULTS[fault])
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_incorrect_on_the_card(workload, cuda, tmp_env):
    """The configuration's lower-precision tier (``control_flags``) at the
    cell's own sizes, a short window: the comparison must refuse it."""
    result = run_cell(Options(workload=workload, seed=20260, seconds=8, trace=False,
                              control=True))
    assert result["correct"] is False, result["checks"]
