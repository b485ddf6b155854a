"""A run whose timed path is broken underneath comes out not correct, and
the lower-precision control reads wider gaps than the program."""
import time

import pytest
import torch

from perfbench import compare, control, harness
from perfbench.tests import tiny


def _step_returns_old_state(monkeypatch):
    from alphazero_tpu_torch.selfplay import actor

    orig = actor._step_and_record

    def broken(env, states, *args, **kw):
        _, record = orig(env, states, *args, **kw)
        return states, record

    monkeypatch.setattr(actor, "_step_and_record", broken)


def _half_batch_evaluated(monkeypatch):
    from alphazero_tpu_torch.models import quant

    orig = quant._chunked_int8_eval

    def broken(qp, obs, *args, **kw):
        h = max(1, obs.shape[0] // 2)
        logits, value = orig(qp, obs[:h], *args, **kw)
        rest = obs.shape[0] - h
        return (torch.cat([logits, logits.mean(0, keepdim=True).expand(rest, -1)]),
                torch.cat([value, value.mean(0, keepdim=True).expand(rest)]))

    monkeypatch.setattr(quant, "_chunked_int8_eval", broken)


def _move_altered(monkeypatch):
    from alphazero_tpu_torch.selfplay import actor

    orig = actor.select_action

    def broken(generator, visit_counts, temperature):
        a = orig(generator, visit_counts, temperature)
        return ((a + 1) % visit_counts.shape[1]).to(a.dtype)

    monkeypatch.setattr(actor, "select_action", broken)


@pytest.mark.parametrize("fault", [_step_returns_old_state, _half_batch_evaluated,
                                   _move_altered])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = tiny.run("gomoku", seed=31337)
    assert not r["correct"]


def test_a_move_altered_in_go_is_not_correct(monkeypatch):
    _move_altered(monkeypatch)
    assert not tiny.run("go", seed=424242)["correct"]


@pytest.mark.parametrize("game", ["gomoku", "go"])
def test_the_control_reads_wider_gaps(game):
    cell = tiny.cell(game)
    ctx = harness.Context(device=torch.device("cpu"), seed=777, seconds=0.3,
                          trace=False, config=cell.config, mix=cell.mix,
                          t_start=time.perf_counter(), log=lambda m: None)
    out = cell.kind.run(ctx)
    rows = out["outcome"].rows
    lg, v = control.control_outputs(cell, rows, out["plain_weights"], 777,
                                    torch.device("cpu"))
    ctl = compare.gaps(lg, v, rows["ref_logits"], rows["ref_value"], rows["legal"])
    prog = out["outcome"].numbers
    assert all(ctl[k] > 2 * prog[k] for k in cell.spec["limits"] if k in ctl)


@pytest.mark.parametrize("game", ["gomoku", "go"])
def test_the_control_comes_out_not_correct(game):
    """The control's numbers go through the verdict every run's go through,
    with the cell's limits: the program is correct, the control is not."""
    cell = harness.find_cell(tiny.CELLS[game],
                             overrides=tiny.overrides(game, control=True))
    line = control.readings(cell, 1000, 0.3, torch.device("cpu"),
                            log=lambda m: None)
    assert line["program"]["correct"] is True
    assert line["control"]["correct"] is False
    assert set(line["control"]["checks"]) == set(cell.spec["limits"])
