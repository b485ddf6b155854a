"""Spans and counters of the port (``alphazero_tpu_torch/utils/telemetry.py``)
and where the self-play step opens them."""
import decimal
import json
import time

import pytest
import torch

from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.quant import make_int8_eval_fn
from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, make_host_actor
from alphazero_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WAVE = ("search.select", "search.leaf", "eval", "search.expand", "search.backup")


def _actor(game="gomoku", n=7, B=4, W=4, sims=32):
    env = registry.create_game(game, n)
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=sims, wave_size=W),
                         recycle=True)
    step, states = make_host_actor(env, make_uniform_eval_fn(env.num_actions, 0.1),
                                   cfg, B, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):  # a few plies so the trees are not all at the root
        states, _ = step(states, gen)
    return env, step, states


def _run(step, states, seed=11):
    return step(states, torch.Generator().manual_seed(seed))


def test_off_is_one_shared_null_context_and_records_nothing():
    assert telemetry.span("a") is telemetry.span("b") is telemetry.host_sync("c")
    with telemetry.span("a") as s:
        assert s is None

    class Untouchable:
        def sum(self):
            raise AssertionError("count_device read its tensor while off")

    telemetry.count("x", 5)
    telemetry.count_device("y", Untouchable())
    env, step, states = _actor()
    _run(step, states)
    with telemetry.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_on_and_off_give_the_same_moves_visits_and_states():
    env, step, states = _actor()
    s_off, r_off = _run(step, states)
    counts_off = step.last_search.visit_counts.clone()
    with telemetry.recording() as rec:
        s_on, r_on = _run(step, states)
    assert rec.spans
    assert torch.equal(step.last_search.visit_counts, counts_off)
    for a, b in zip(r_on, r_off):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for f in ("board", "to_play", "move_count", "terminal", "winner"):
        assert torch.equal(getattr(s_on, f), getattr(s_off, f)), f


def _children(rec, parent):
    return [s for s in rec.spans if s.parent == parent.id]


def test_one_step_nests_its_waves_and_counts_its_positions():
    B, W, sims = 4, 4, 32
    env, step, states = _actor(B=B, W=W, sims=sims)
    with telemetry.recording() as rec:
        _run(step, states)
    by_id = {s.id: s for s in rec.spans}
    (top,) = [s for s in rec.spans if s.name == telemetry.STEP]
    assert top.parent is None and top.step == top.id
    for s in rec.spans:
        assert s.step == top.id and s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end
    waves = [s for s in rec.spans if s.name == "search.wave"]
    assert len(waves) == sims // W
    assert all(w.parent == top.id for w in waves)
    for w in waves:
        names = [c.name for c in _children(rec, w)]
        assert sorted(n for n in names if n in WAVE) == sorted(WAVE), names
    assert [c.name for c in _children(rec, top)].count("search.roots") == 1
    assert [c.name for c in _children(rec, top)].count("actor.move") == 1
    c = rec.counters
    assert c["eval.positions"] == B + B * W * (sims // W)
    assert c["search.rows"] == B * W * (sims // W)
    assert rec.step_counters[top.id] == c


@pytest.mark.parametrize("game,n", [("gomoku", 7), ("go", 9)])
def test_host_syncs_count_every_blocking_read(game, n, monkeypatch):
    """``host_sync.search.select`` is the depth loop's tests (every
    ``bool`` of a tensor in the step); ``host_sync.go.group_labels`` is
    Go's ``torch.equal`` calls."""
    env, step, states = _actor(game, n, B=2, W=4, sims=16)
    calls = {"bool": 0, "equal": 0}
    tensor_bool, equal = torch.Tensor.__bool__, torch.equal

    def counted_bool(t):
        calls["bool"] += 1
        return tensor_bool(t)

    def counted_equal(a, b):
        calls["equal"] += 1
        return equal(a, b)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    monkeypatch.setattr(torch, "equal", counted_equal)
    with telemetry.recording() as rec:
        _run(step, states)
    monkeypatch.undo()
    c = rec.counters
    assert c["host_sync.search.select"] == calls["bool"] > 0
    assert c.get("host_sync.go.group_labels", 0) == calls["equal"]
    assert (calls["equal"] > 0) == (game == "go")
    syncs = sum(v for k, v in c.items() if k.startswith("host_sync."))
    assert syncs == sum(s.name == telemetry.SYNC for s in rec.spans)


@pytest.mark.parametrize("rows,chunk,spans", [(96, 32, 3), (64, 32, 2), (40, 32, 0)])
def test_int8_executor_opens_one_span_a_chunk(rows, chunk, spans):
    env = registry.create_game("gomoku", 7)
    cfg = ResNetConfig(num_blocks=1, channels=16, policy_channels=4,
                       value_channels=4, value_hidden=16)
    model = AZResNet(env.num_actions, cfg, env.observation_shape).eval()
    eval_fn = make_int8_eval_fn(model, chunk=chunk)
    obs = env.observation(env.init(rows, device="cpu"))
    with telemetry.recording() as rec:
        logits, _ = eval_fn(obs)
    assert logits.shape[0] == rows
    assert [s.name for s in rec.spans] == ["eval.chunk"] * spans


def test_new_nodes_leave_out_the_duplicate_walkers():
    """More walkers a wave than legal moves (49 on 7x7): duplicates are
    evaluated and dropped, and the new nodes are the arena's filled slots."""
    B, W = 2, 64
    env = registry.create_game("gomoku", 7)
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=2 * W, wave_size=W))
    step, states = make_host_actor(env, make_uniform_eval_fn(49, 0.1), cfg, B,
                                   device="cpu")
    with telemetry.recording() as rec:
        _run(step, states)
    tree = step.last_search.tree
    filled = int((tree.visits[:, 1:] > 0).sum())
    assert filled == int((tree.parent[:, 1:] >= 0).sum())
    assert rec.counters["search.new_nodes"] == filled
    assert rec.counters["search.rows"] == 2 * B * W > filled


def test_export_chrome_round_trips_on_the_profilers_time_base(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.recording() as rec:
            with telemetry.span(telemetry.STEP):
                telemetry.count("n", 3)
                with telemetry.span("inner"):
                    time.sleep(0.002)
                    a.mm(a)
                    time.sleep(0.002)
                telemetry.count_device("d", torch.ones(5, dtype=torch.bool))
            telemetry.count("n")
    telemetry.export_chrome(rec, tmp_path / "spans.json")
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    spans = json.loads((tmp_path / "spans.json").read_text(),
                       parse_float=decimal.Decimal)
    base = spans["baseTimeNanoseconds"]
    xs = [e for e in spans["traceEvents"] if e["ph"] == "X"]
    back = sorted(telemetry.Span(e["args"]["id"], e["args"]["parent"], e["name"],
                                 base + int(e["ts"] * 1000),
                                 base + int((e["ts"] + e["dur"]) * 1000),
                                 e["args"]["step"]) for e in xs)
    assert back == sorted(rec.spans)
    cs = {e["name"]: e["args"]["value"] for e in spans["traceEvents"]
          if e["ph"] == "C"}
    assert cs == {"n": 4, "d": 5} == dict(rec.counters)

    # The profiler's trace has the same base, and its matmul lies inside
    # the span that ran it.
    trace = json.loads((tmp_path / "profile.json").read_text())
    assert trace["baseTimeNanoseconds"] == base
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    (inner,) = [e for e in xs if e["name"] == "inner"]
    assert inner["ts"] <= decimal.Decimal(str(mm["ts"]))
    assert decimal.Decimal(str(mm["ts"] + mm["dur"])) <= inner["ts"] + inner["dur"]


def test_one_recording_at_a_time():
    with telemetry.recording():
        with pytest.raises(RuntimeError):
            with telemetry.recording():
                pass
    assert telemetry.span("x") is telemetry.span("y")


def test_self_play_spans_writes_the_runs_steps(tmp_path, capsys):
    from alphazero_tpu_torch.scripts import self_play

    path = tmp_path / "spans.json"
    self_play.main(["--device", "cpu", "--board-size", "7", "--num-games", "2",
                    "--simulations", "8", "--wave", "4", "--max-moves", "3",
                    "--output-dir", str(tmp_path / "games"), "--spans", str(path)])
    capsys.readouterr()
    events = json.loads(path.read_text())["traceEvents"]
    steps = [e for e in events if e["name"] == telemetry.STEP]
    assert len(steps) == 3
    counters = {e["name"]: e["args"]["value"] for e in events if e["ph"] == "C"}
    assert counters["eval.positions"] == 3 * (2 + 2 * 8)
