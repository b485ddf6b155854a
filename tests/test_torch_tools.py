"""The tools of ``alphazero_tpu_torch/tools/`` against the JAX tools under
``tools/``: the six training recipes field by field, the records' keys
(the committed records in ``docs/``), the A/B's routing (through
``chip_smoke.RoutingCheck``) and Elo, the legs' merge and its figure, and
the Renju fuzz's counts; and the rule that they write only where
``--output`` says."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import production
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.eval import anchors, arena
from alphazero_tpu_torch.models.io import save_model
from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.tools import (
    _common, ab_arena, fuzz_renju, merge_flagship_legs, train_demo, train_flagship,
    train_flagship2, train_zoo_chess, train_zoo_go9,
)
from alphazero_tpu_torch.utils import config as tconfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs")
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TINY = ResNetConfig(num_blocks=1, channels=16)

# name -> (JAX tool, port module, env knobs)
RECIPES = {
    "train_demo": ("train_demo.py", train_demo, {}),
    "train_demo_go": ("train_demo.py", train_demo, {"DEMO_GAME": "go", "DEMO_ITERS": "3"}),
    "train_zoo_go9": ("train_zoo_go9.py", train_zoo_go9, {}),
    "train_zoo_chess": ("train_zoo_chess.py", train_zoo_chess, {}),
    "train_flagship": ("train_flagship.py", train_flagship, {}),
    "train_flagship2": ("train_flagship2.py", train_flagship2, {"FLAG2_RECYCLE": "1"}),
}

_CAPTURE = r"""
import importlib.util, json, os, sys
sys.path.insert(0, sys.argv[1])
import alphazero_tpu.training.pipeline as P
from alphazero_tpu.utils import config as C

class Captured(Exception):
    pass

class Stub:
    def __init__(self, cfg, *a, **kw):
        raise Captured(cfg)

P.Pipeline = Stub
out = {}
for name, (tool, knobs) in json.loads(sys.argv[2]).items():
    saved = dict(os.environ)
    os.environ.update(knobs)
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(sys.argv[1], "tools", tool))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        mod.main()
    except Captured as e:
        out[name] = C.to_dict(e.args[0])
    os.environ.clear()
    os.environ.update(saved)
print(json.dumps(out))
"""


def _without(d, drop=("checkpoint_dir",)):
    return {k: (_without(v, ()) if isinstance(v, dict) else v)
            for k, v in d.items() if k not in drop and "dtype" not in k}


@pytest.fixture(scope="module")
def jax_recipes():
    """Every JAX training tool imported in one subprocess with its
    ``Pipeline`` replaced by a stub that raises with the config, so nothing
    trains; the configs as ``utils/config.to_dict`` gives them."""
    spec = {n: (tool, knobs) for n, (tool, _, knobs) in RECIPES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CAPTURE, REPO, json.dumps(spec)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=240, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_equals_jax(name, jax_recipes, monkeypatch):
    """Field by field, the dtypes aside; the checkpoint directory lies
    beside ``--output`` in the port (the JAX tools name one under /tmp)."""
    _, mod, knobs = RECIPES[name]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    ours = tconfig.to_dict(mod.recipe(mod.knobs(), "unused"))
    assert _without(ours) == _without(jax_recipes[name])


def _tree_state(*dirs):
    out = {}
    for d in dirs:
        for root, _, files in os.walk(d):
            for f in files:
                st = os.stat(os.path.join(root, f))
                out[os.path.join(root, f)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.fixture
def untouched():
    """Fails the test if any file under docs/ or models_zoo/ changed."""
    dirs = (DOCS, os.path.join(REPO, "models_zoo"))
    before = _tree_state(*dirs)
    yield
    assert _tree_state(*dirs) == before


@pytest.fixture
def tiny(monkeypatch):
    """Shrinks a tool's recipe: board ``size``, a 1x16 net, W=4, 8-move
    games, 2 learner steps of 32 rows; the int8 calibration on 8 games."""
    monkeypatch.setattr(production, "CALIB_GAMES", 8)

    def shrink(mod, size, max_moves=8):
        orig = mod.recipe

        def recipe(k, ckpt):
            c = orig(k, ckpt)
            sp = c.selfplay
            return dataclasses.replace(
                c, board_size=size, model=TINY, train_batch_size=32,
                train_steps_per_iteration=2, min_replay_before_training=1,
                selfplay=dataclasses.replace(
                    sp, max_moves=max_moves,
                    mcts=dataclasses.replace(sp.mcts, wave_size=min(4, sp.mcts.wave_size))))
        monkeypatch.setattr(mod, "recipe", recipe)
    return shrink


def _keys(name):
    with open(os.path.join(DOCS, name)) as f:
        doc = json.load(f)
    return doc[-1] if isinstance(doc, list) else doc


def test_go9_tiny_run_writes_jax_keys(tmp_path, tiny, monkeypatch, untouched):
    tiny(train_zoo_go9, 5)
    monkeypatch.setattr(train_zoo_go9, "MAX_MOVES", 8)
    for k, v in dict(G9_ITERS="1", G9_GAMES="4", G9_SIMS="8", G9_EVAL_SIMS="8",
                     G9_EVAL_GAMES="4").items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "go9.json"
    payload = train_zoo_go9.main(["--device", "cpu", "--output", str(out),
                                  "--ladder", "uniform_mcts_16,uniform_mcts_64"])
    ref = _keys("train_zoo_go9.json")
    assert json.loads(out.read_text()) == payload
    assert sorted(payload) == sorted(ref)
    assert sorted(payload["config"]) == sorted(ref["config"])
    assert set(ref["history"][0]) <= set(payload["history"][0])
    assert [m[:2] for m in payload["matches"]] == [
        ["zoo_go9", "uniform_mcts_16"], ["zoo_go9", "uniform_mcts_64"],
        ["uniform_mcts_16", "uniform_mcts_64"]]
    assert all(sum(m[2:]) == 4 for m in payload["matches"])
    assert sorted(os.listdir(tmp_path)) == ["go9.json", "zoo_go9", "zoo_go9.json"]


def test_chess_tiny_run_writes_jax_keys(tmp_path, tiny, monkeypatch, untouched):
    tiny(train_zoo_chess, 8, max_moves=4)
    for k, v in dict(CZ_ITERS="1", CZ_GAMES="2", CZ_SIMS="8", CZ_MAX_MOVES="4",
                     CZ_EVAL_SIMS="8", CZ_EVAL_GAMES="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(train_zoo_chess, "EVAL_800", ("uniform_mcts_16",))
    payload = train_zoo_chess.main(["--device", "cpu", "--output",
                                    str(tmp_path / "c.json"), "--ladder", "uniform_mcts_16"])
    ref = _keys("train_zoo_chess.json")
    assert sorted(payload) == sorted(ref)
    assert sorted(payload["config"]) == sorted(ref["config"])
    assert [r[:2] for r in payload["eval_800"]] == [["zoo_chess@800", "uniform_mcts_16"]]
    assert payload["matches"][0][2:] and sum(payload["matches"][0][2:]) == 2


def test_demo_tiny_run_writes_jax_keys(tmp_path, tiny, monkeypatch, untouched, capsys):
    tiny(train_demo, 5)
    monkeypatch.setattr(train_demo, "ARENA_GAMES", 4)
    for k, v in dict(DEMO_ITERS="1", DEMO_GAMES="4", DEMO_SIMS="8",
                     DEMO_BOARD="5").items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "demo.json"
    result = train_demo.main(["--device", "cpu", "--output", str(out)])
    ref = _keys("train_demo_gomoku9.json")
    assert sorted(result) == sorted(ref)
    assert sorted(result["arena_vs_random"]) == sorted(ref["arena_vs_random"])
    assert sum(result["arena_vs_random"].values()) == 4
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == ["final_loss", "first_loss", "game", "train_wall_s",
                            "win_rate_vs_random"]
    assert sorted(os.listdir(tmp_path)) == ["demo.json", "demo_ckpt"]


def test_flagship_tiny_run_writes_jax_keys(tmp_path, tiny, monkeypatch, untouched):
    tiny(train_flagship, 5)
    for k, v in dict(FLAG_ITERS="2", FLAG_GAMES="4", FLAG_SIMS="8", FLAG_EVAL_EVERY="1",
                     FLAG_EVAL_GAMES="2", FLAG_EVAL_SIMS="4").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(arena.ArenaConfig, "__init__", _short_arena(arena.ArenaConfig.__init__))
    payload = train_flagship.main(["--device", "cpu", "--output", str(tmp_path / "f.json")])
    ref = _keys("train_flagship_gomoku15.json")
    assert sorted(payload) == sorted(ref)
    assert sorted(payload["config"]) == sorted(ref["config"])
    assert [(s["player"], s["opponent"]) for s in payload["arena_series"]] == [
        ("iter_1", "iter_0"), ("iter_2", "iter_0"), ("iter_2", "iter_1")]
    assert sorted(os.listdir(tmp_path)) == [
        "f.json", "f_elo.png", "f_loss.png", "flagship_gomoku15", "flagship_gomoku15.json"]


def _short_arena(init):
    """ArenaConfig with its plies capped at 8 (the recipes' 225 at 5x5 would
    run past the board)."""
    def short(self, *a, **kw):
        init(self, *a, **kw)
        object.__setattr__(self, "max_moves", min(self.max_moves, 8))
    return short


def test_flagship2_tiny_resume_writes_jax_keys(tmp_path, tiny, monkeypatch, untouched):
    """A resume from a bundle, the anchors' round-robin played (no table
    at ``--anchor-table``) and written beside ``--output``."""
    tiny(train_flagship2, 5)
    env = registry.create_game("gomoku", 5)
    start = tmp_path / "start"
    save_model(str(start), AZResNet(env.num_actions, TINY, env.observation_shape,
                                    torch.Generator().manual_seed(3)),
               "resnet", env.num_actions, TINY)
    monkeypatch.setattr(anchors, "POOL", ("uniform_mcts_16", "attack_defense_64"))
    monkeypatch.setattr(arena.ArenaConfig, "__init__", _short_arena(arena.ArenaConfig.__init__))
    orig_sides = arena.play_match_sides
    monkeypatch.setattr(arena, "play_match_sides",
                        lambda *a, **kw: orig_sides(*a, **dict(kw, max_moves=8)))
    for k, v in dict(FLAG2_ITERS="1", FLAG2_GAMES="4", FLAG2_SIMS="8", FLAG2_EVAL_GAMES="2",
                     FLAG2_ANCHOR_GAMES="2", FLAG2_EVAL_SIMS="4",
                     FLAG2_START=str(start), FLAG2_TAG="_t").items():
        monkeypatch.setenv(k, v)
    out_dir = tmp_path / "out"
    payload = train_flagship2.main(["--device", "cpu", "--output",
                                    str(out_dir / "train_flagship2_t.json"),
                                    "--anchor-table", str(tmp_path / "none.json")])
    ref = _keys("train_flagship2_leg2.json")
    assert sorted(payload) == sorted(ref)
    assert sorted(payload["config"]) == sorted(ref["config"])
    names = [tuple(m[:2]) for m in payload["matches"]]
    assert names == [("uniform_mcts_16", "attack_defense_64"),
                     ("r4_final", "uniform_mcts_16"), ("r4_final", "attack_defense_64"),
                     ("it_17", "uniform_mcts_16"), ("it_17", "attack_defense_64"),
                     ("it_17", "r4_final")]
    assert sorted(os.listdir(out_dir)) == [
        "anchor_table.json", "flagship2_gomoku15", "flagship2_gomoku15.json",
        "flagship2_snaps", "train_flagship2_t.json", "train_flagship2_t_elo.png"]


def _recipe_tiny(tiny, monkeypatch):
    """The flagship recipe at 15x15 (``scripts/anchor_eval.py`` rates
    15x15 bundles) shrunk by ``tiny``: 1 iteration of 4 games at 8 sims, a
    2-game recipe arena at 4 sims; the rating against two anchors, 2 games
    each, every game capped at 8 plies."""
    tiny(train_flagship, 15)
    for k, v in dict(FLAG_ITERS="1", FLAG_GAMES="4", FLAG_SIMS="8",
                     FLAG_EVAL_GAMES="2", FLAG_EVAL_SIMS="4").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(arena.ArenaConfig, "__init__", _short_arena(arena.ArenaConfig.__init__))
    orig_sides = arena.play_match_sides
    monkeypatch.setattr(arena, "play_match_sides",
                        lambda *a, **kw: orig_sides(*a, **dict(kw, max_moves=8)))
    monkeypatch.setattr(anchors, "POOL", ("uniform_mcts_16", "attack_defense_64"))


@pytest.fixture(scope="module")
def jax_flagship_docs():
    rating = next(r for r in json.loads((open(os.path.join(DOCS, "anchor_evals.json"))).read())
                  if r["candidate"] == "flagship_gomoku15@800")
    return _keys("train_flagship_gomoku15.json"), rating


def test_recipe_modes_differ_only_in_inference(tmp_path, tiny, monkeypatch, untouched,
                                               jax_flagship_docs):
    """``chip_smoke.py --recipe``: both modes run ``train_flagship.main``
    and rate its bundle with ``anchor_eval``; their ``PipelineConfig``s
    differ only in ``inference`` (folded, and the tool's untouched int8);
    the folded actor never reaches the int8 executor, the int8 actor
    builds it once an iteration and evaluates through it; each mode writes
    the JAX records' keys (``train_flagship_gomoku15.json``, the
    ``anchor_evals.json`` row) and nothing under docs/ or models_zoo/."""
    _recipe_tiny(tiny, monkeypatch)
    jax_train, jax_rating = jax_flagship_docs
    runs = {}
    for mode, inference in chip_smoke.RECIPE_MODES.items():
        with contextlib.redirect_stdout(io.StringIO()):
            res = chip_smoke.flagship_run(inference, str(tmp_path), torch.device("cpu"),
                                          rate_games=2, rate_sims=4)
        assert res.pop("kernel_calls").cases  # the search's gathers were recorded
        summary = chip_smoke.recipe_summary(mode, res, jax_train, jax_rating)
        assert summary["keys"] == {"record": True, "config": True, "history": True,
                                   "rating": True}
        assert chip_smoke._launch_faults(res["inference"], res["launches"]["iterations"],
                                         on_card=False) == []
        assert summary["cut"] and summary["iterations"] == 1
        assert [a["anchor"] for a in summary["anchors"]] == list(anchors.POOL)
        assert summary["bt_band"][0] < summary["bt"] < summary["bt_band"][1]
        assert sorted(os.listdir(tmp_path)) == [
            "anchor_evals.json", "flagship_gomoku15", "flagship_gomoku15.json",
            "train_flagship_gomoku15.json", "train_flagship_gomoku15_elo.png",
            "train_flagship_gomoku15_loss.png"]
        for name in ("anchor_evals.json", "train_flagship_gomoku15.json"):
            os.remove(tmp_path / name)
        runs[mode] = res
    folded, int8 = runs["flagship-folded"], runs["flagship-int8"]
    assert int8["config"].inference == production.INFERENCE == "int8"
    assert folded["config"] == dataclasses.replace(int8["config"], inference="folded")
    assert folded["launches"]["iterations"] == [
        {"gather_rows": 0, "s8_mm": 0, "int8_builds": 0, "int8_evals": 0}]
    it = int8["launches"]["iterations"][0]
    assert it["int8_builds"] == 1 and it["int8_evals"] > 0


_TIMES = {"actor_s", "train_s", "moves_per_s", "host_rss_mb", "device_mem_mb",
          "device_peak_mb"}


def _untimed(history):
    return [{k: v for k, v in h.items() if k not in _TIMES} for h in history]


def test_recipe_legs_equal_one_run(tmp_path, tiny, monkeypatch, untouched):
    """``chip_smoke.py --recipe MODE --until N``: the tiny recipe (4
    iterations, an arena every 2) in three legs, stopped after iteration 0,
    after iteration 2 and run to the end, equals one run bit for bit: the
    record (history without its times, arena series, Elo table), the final
    bundle (weights and BatchNorm statistics) and the rating's matches.
    The legs resume each way a kept net can come back: iteration 0's from
    the seed, iteration 2's from its bundle (the third leg starts at 3);
    each held against the sha256 of the bundle the leg before wrote."""
    _recipe_tiny(tiny, monkeypatch)
    for k, v in dict(FLAG_ITERS="4", FLAG_EVAL_EVERY="2").items():
        monkeypatch.setenv(k, v)
    runs = {}
    for name, stops in (("one", [None]), ("legs", [1, 3, None])):
        out_dir = tmp_path / name
        for until in stops:
            with contextlib.redirect_stdout(io.StringIO()):
                res = chip_smoke.flagship_run("folded", str(out_dir), torch.device("cpu"),
                                              rate_games=2, rate_sims=4, until=until,
                                              legs_dir=str(out_dir / "legs"))
            assert res["done"] == (until is None)
        runs[name] = res
        with open(out_dir / "flagship_gomoku15", "rb") as f:
            runs[name + "_bundle"] = f.read()
    one, legs = runs["one"], runs["legs"]
    assert legs["leg"] == [3, 4] and one["leg"] == [0, 4]
    assert _untimed(legs["record"]["history"]) == _untimed(one["record"]["history"])
    assert len(one["record"]["history"]) == 4 and "loss" in one["record"]["history"][-1]
    for key in ("arena_series", "elo"):
        assert legs["record"][key] == one["record"][key], key
    assert [s["opponent"] for s in one["record"]["arena_series"]] == [
        "iter_0", "iter_0", "iter_2"]
    assert runs["legs_bundle"] == runs["one_bundle"]
    assert legs["rating"]["matches"] == one["rating"]["matches"]
    assert legs["rating"]["bt_rating"] == one["rating"]["bt_rating"]
    assert len(legs["launches"]["iterations"]) == 4
    saved = sorted(os.listdir(tmp_path / "legs" / "legs"))
    assert saved == ["elo.json", "iter_0", "iter_0.json", "iter_2", "iter_2.json",
                     "legs.json"]


def test_recipe_leg_refuses_other_knobs(tmp_path, tiny, monkeypatch, untouched):
    """A leg resumes only the run its knobs describe, and only forward."""
    _recipe_tiny(tiny, monkeypatch)
    monkeypatch.setenv("FLAG_ITERS", "2")
    legs = str(tmp_path / "legs")
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.flagship_run("folded", str(tmp_path), torch.device("cpu"),
                                rate_games=0, until=1, legs_dir=legs)
        with pytest.raises(ValueError, match="done"):
            chip_smoke.flagship_run("folded", str(tmp_path), torch.device("cpu"),
                                    rate_games=0, until=1, legs_dir=legs)
        monkeypatch.setenv("FLAG_GAMES", "2")
        with pytest.raises(ValueError, match="ran at"):
            chip_smoke.flagship_run("folded", str(tmp_path), torch.device("cpu"),
                                    rate_games=0, legs_dir=legs)


def test_recipe_seed_control_changes_only_the_seed(tmp_path, tiny, monkeypatch, untouched):
    """``--seed S`` replaces ``PipelineConfig.seed`` and nothing else (the
    checkpoint directory lies beside each run's output), and the run ends
    with another net."""
    _recipe_tiny(tiny, monkeypatch)
    runs = {}
    for seed in (None, 1):
        with contextlib.redirect_stdout(io.StringIO()):
            runs[seed] = chip_smoke.flagship_run("folded", str(tmp_path / str(seed)),
                                                 torch.device("cpu"), rate_games=0, seed=seed)
    base, other = runs[None]["config"], runs[1]["config"]
    assert base.seed == 0 and other == dataclasses.replace(
        base, seed=1, checkpoint_dir=other.checkpoint_dir)
    assert runs[None]["history"][0]["moves"] > 0
    with open(tmp_path / "None" / "flagship_gomoku15", "rb") as a, \
            open(tmp_path / "1" / "flagship_gomoku15", "rb") as b:
        assert a.read() != b.read()


def test_recipe_arenas_evaluate_the_raw_net(tmp_path, tiny, monkeypatch, untouched):
    """``train_flagship``'s and ``train_demo``'s arenas evaluate their nets
    as JAX's tools do (``model.apply``: ``make_raw_eval_fn``), bit for bit,
    and not through the BN-folded bf16 net."""
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn, make_raw_eval_fn
    from alphazero_tpu_torch.tools import train_demo as demo
    from alphazero_tpu_torch.training import pipeline

    seen, pipes = [], []
    real, real_init = arena.play_match, pipeline.Pipeline.__init__

    def spy(env, eval_a, eval_b, *a, **kw):
        seen.append(eval_a)
        return real(env, eval_a, eval_b, *a, **kw)

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        pipes.append(self)

    monkeypatch.setattr(arena, "play_match", spy)
    monkeypatch.setattr(pipeline.Pipeline, "__init__", init)
    monkeypatch.setattr(arena.ArenaConfig, "__init__", _short_arena(arena.ArenaConfig.__init__))
    tiny(train_flagship, 5)
    tiny(demo, 5)
    monkeypatch.setattr(demo, "ARENA_GAMES", 2)
    for k, v in dict(FLAG_ITERS="1", FLAG_GAMES="4", FLAG_SIMS="8", FLAG_EVAL_GAMES="2",
                     FLAG_EVAL_SIMS="4", DEMO_ITERS="1", DEMO_GAMES="4", DEMO_SIMS="8",
                     DEMO_BOARD="5").items():
        monkeypatch.setenv(k, v)
    with contextlib.redirect_stdout(io.StringIO()):
        train_flagship.main(["--device", "cpu", "--output", str(tmp_path / "f.json")])
        demo.main(["--device", "cpu", "--output", str(tmp_path / "d.json")])
    assert len(seen) == len(pipes) == 2
    obs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 2, size=(8, 11, 5, 5)).astype(np.float32))
    for eval_fn, pipe in zip(seen, pipes):
        net = pipe.state.module  # after training: the net both arenas played
        got, want = eval_fn(obs), make_raw_eval_fn(net)(obs)
        folded = make_inference_eval_fn(net)(obs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert not all(torch.equal(g, f) for g, f in zip(got, folded))


@pytest.mark.parametrize("iters, prefix", [(4, (256, 256)), (8, (501, 512)),
                                           (16, (1024, 1024))])
def test_cut_recipe_shares_the_full_runs_schedule(iters, prefix):
    """The flagship recipe's warm-up (500 learner steps) does not depend on
    ``total_steps``: a 4-iteration cut runs the full run's learning rates
    throughout, an 8-iteration cut for its first 501 steps."""
    knobs = dict(train_flagship.knobs(), iters=iters)
    assert chip_smoke.schedule_prefix(train_flagship, knobs, 16) == prefix


def test_bt_band_of_jax_flagship_rating(jax_flagship_docs):
    """The band is the rating -+ 2 standard errors from the Fisher
    information of the candidate's games; four times the games halve it."""
    _, rating = jax_flagship_docs
    lo, hi = chip_smoke.bt_band(rating)
    assert lo < rating["bt_rating"] < hi
    assert abs((hi - rating["bt_rating"]) - (rating["bt_rating"] - lo)) < 0.2
    more = dict(rating, matches=[m[:2] + [4 * x for x in m[2:]] for m in rating["matches"]])
    lo4, hi4 = chip_smoke.bt_band(more)
    assert abs((hi4 - lo4) - (hi - lo) / 2) < 0.3


def test_outputs_under_docs_or_models_zoo_are_refused(untouched):
    for path in ("docs/train_zoo_go9.json", os.path.join(REPO, "models_zoo", "x.json")):
        with pytest.raises(ValueError):
            _common.check_output(os.path.join(REPO, path))
        with pytest.raises(ValueError):
            train_zoo_go9.main(["--device", "cpu", "--output", os.path.join(REPO, path)])
    assert _common.check_output("build/tools/x.json").endswith("build/tools/x.json")


# ---- ab_arena ---------------------------------------------------------------

def _stub_evaluators(monkeypatch, seen):
    """The int8 and bf16 evaluators replaced by uniform stubs that record
    the rows they get."""
    from alphazero_tpu_torch.models import quant, resnet

    def stub(name):
        base = make_uniform_eval_fn(225, value_noise=0.1)

        def f(obs, to_play=None):
            seen[name].append(obs.shape[0])
            return base(obs, to_play)
        return f

    monkeypatch.setattr(quant, "make_int8_eval_fn", lambda *a, **kw: stub("int8"))
    monkeypatch.setattr(resnet, "make_inference_eval_fn", lambda *a, **kw: stub("bf16"))
    monkeypatch.setattr(ab_arena, "calib_obs", lambda *a: None)


@pytest.mark.parametrize("host", ["1", "0"])
def test_int8_ab_routes_each_lane_to_its_side(host, tmp_path, monkeypatch, untouched):
    """At W=4 each side's stub evaluates exactly the rows of the lanes it
    moves (the routing check holds every call), half of every wave."""
    seen = {"int8": [], "bf16": []}
    _stub_evaluators(monkeypatch, seen)
    for k, v in dict(AB_GAMES="4", AB_SIMS="8", AB_WAVE="4", AB_HOST=host,
                     AB_OPENING="2").items():
        monkeypatch.setenv(k, v)
    if host == "0":  # play_match runs every ply: cap them
        monkeypatch.setattr(arena.ArenaConfig, "__init__",
                            _short_arena(arena.ArenaConfig.__init__))
    env = registry.create_game("gomoku", 15)
    out = tmp_path / "ab.json"
    with chip_smoke.RoutingCheck(env) as chk:
        rec = ab_arena.main(["int8", "--device", "cpu", "--output", str(out)])
    assert chk.faults == [] and chk.calls > 0
    assert chk.rows == {"a": sum(seen["int8"]), "b": sum(seen["bf16"])}
    assert seen["int8"] == seen["bf16"]  # two lanes each, every call
    assert set(seen["int8"]) == {2, 2 * 4}  # the roots, then the waves
    assert rec["wins_a"] + rec["wins_b"] + rec["draws"] == rec["games"] == 4
    assert sorted(rec) == sorted(_keys("ab_results.json"))
    assert json.loads(out.read_text()) == [rec]


def test_routing_check_catches_the_jax_split(tmp_path, monkeypatch, untouched):
    """With the JAX arena's split (``half`` rows, not ``half * W``) the check
    reports the misrouted calls."""
    seen = {"int8": [], "bf16": []}
    _stub_evaluators(monkeypatch, seen)
    for k, v in dict(AB_GAMES="4", AB_SIMS="8", AB_WAVE="4", AB_OPENING="2").items():
        monkeypatch.setenv(k, v)

    def jax_mover(eval_a, eval_b, half, black_to_move, num_games):
        first, second = (eval_a, eval_b) if black_to_move else (eval_b, eval_a)

        def f(obs, to_play):
            la, va = first(obs[:half], to_play[:half])
            lb, vb = second(obs[half:], to_play[half:])
            return torch.cat([la.float(), lb.float()]), torch.cat([va.float(), vb.float()])
        return f

    monkeypatch.setattr(arena, "make_mover_eval_fn", jax_mover)
    env = registry.create_game("gomoku", 15)
    with chip_smoke.RoutingCheck(env) as chk:
        ab_arena.main(["int8", "--device", "cpu", "--output", str(tmp_path / "ab.json")])
    assert chk.faults and all(f["rows"] != 8 for f in chk.faults)


def test_reuse_ab_searches_each_side_on_its_own_moves(tmp_path, monkeypatch, untouched):
    seen = {"int8": [], "bf16": []}
    _stub_evaluators(monkeypatch, seen)
    for k, v in dict(AB_GAMES="4", AB_SIMS="8", AB_WAVE="4", AB_OPENING="2").items():
        monkeypatch.setenv(k, v)
    env = registry.create_game("gomoku", 15)
    with chip_smoke.RoutingCheck(env) as chk:
        rec = ab_arena.main(["reuse", "--device", "cpu", "--output",
                             str(tmp_path / "ab.json")])
    assert chk.faults == [] and chk.rows["a"] > 0 and chk.rows["b"] > 0
    assert rec["a"] == "reuse_fixed" and rec["games"] == 4
    assert sorted(rec) == sorted(_keys("ab_results.json"))


@pytest.mark.parametrize("mode", ["null", "sides"])
def test_ab_controls_route_each_lane_to_its_side(mode, monkeypatch, untouched):
    """``chip_smoke.ab_control``: ``null`` puts one net on both sides of the
    batched match (each wave split in halves), ``sides`` gives the int8
    executor and the folded net a search each; records in the tool's keys."""
    seen = {"int8": [], "bf16": []}
    _stub_evaluators(monkeypatch, seen)
    for k, v in dict(AB_GAMES="4", AB_SIMS="8", AB_WAVE="4", AB_OPENING="2").items():
        monkeypatch.setenv(k, v)
    env = registry.create_game("gomoku", 15)
    with chip_smoke.RoutingCheck(env) as chk, contextlib.redirect_stdout(io.StringIO()):
        rec = chip_smoke.ab_control(mode, torch.device("cpu"))
    assert chk.faults == [] and chk.rows["a"] > 0 and chk.rows["b"] > 0
    assert rec["mode"] == mode and rec["b"] == "bf16_folded"
    assert rec["wins_a"] + rec["wins_b"] + rec["draws"] == rec["games"] == 4
    assert sorted(rec) == sorted(_keys("ab_results.json"))
    if mode == "null":
        assert rec["a"] == "bf16_folded" and not seen["int8"]
        assert chk.rows["a"] == chk.rows["b"] == sum(seen["bf16"]) // 2
    else:
        assert rec["a"].startswith("int8_trunk")
        assert chk.calls > 0 and seen["int8"] and seen["bf16"]


@pytest.fixture
def jax_ab(monkeypatch):
    """``tools/ab_arena.py`` imported from its path, its compile-cache
    options put back after."""
    import jax

    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "ab_arena_jax", os.path.join(REPO, "tools", "ab_arena.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    for k, v in keep.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("result", [(3, 1, 0), (4, 0, 0), (0, 4, 0), (2, 2, 0),
                                    (1, 2, 1), (0, 0, 4)])
def test_ab_record_and_elo_equal_jax(result, jax_ab, tmp_path, monkeypatch):
    """The record (score, Elo delta and its string form for a sweep) with
    both tools' match replaced by the same fixed result; ``wall_s`` aside."""
    wa, wb, dr = result

    def fixed(*a, **kw):
        return {"a": "int8_trunk_p99.99", "b": "bf16_folded", "wins_a": wa,
                "wins_b": wb, "draws": dr}

    monkeypatch.setattr(jax_ab, "load_net", lambda: (None, None, None))
    monkeypatch.setattr(jax_ab, "run_int8_ab", fixed)
    monkeypatch.setattr(ab_arena, "load_net", lambda dev: (None, None))
    monkeypatch.setattr(ab_arena, "run_int8_ab", fixed)
    (tmp_path / "docs").mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["ab_arena.py", "int8"])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_ab.main()
        ours = ab_arena.main(["int8", "--device", "cpu", "--output", "ours.json"])
    (theirs,) = json.loads((tmp_path / "docs" / "ab_results.json").read_text())
    theirs.pop("wall_s"), ours.pop("wall_s")
    assert ours == theirs
    lo, hi = _common.elo_interval(wa, wb, dr)
    elo = _common.elo_from_score((wa + 0.5 * dr) / 4)
    assert lo <= elo <= hi or not math.isfinite(elo)


# ---- merge and fuzz ------------------------------------------------------------

def test_merge_flagship_legs_equals_jax(tmp_path, monkeypatch):
    """The committed legs 2 and 3 and a synthetic log (one duplicate of a
    leg's row, one row of its own, one line that is not a match); the
    figure pixel for pixel."""
    import jax
    import matplotlib.image
    import numpy as np

    log = tmp_path / "leg1.log"
    with open(os.path.join(DOCS, "train_flagship2_leg2.json")) as f:
        dup = json.load(f)["matches"][5]
    log.write_text("noise line\n  match {} vs {}: +{} -{} ={}\n".format(*dup)
                   + "  match scratch vs uniform_mcts_16: +3 -61 =0\n")
    legs = [os.path.join(DOCS, f"train_flagship2_leg{i}.json") for i in (2, 3)]
    keep = jax.config.jax_platforms
    spec = importlib.util.spec_from_file_location(
        "merge_jax", os.path.join(REPO, "tools", "merge_flagship_legs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_platforms", keep)
    (tmp_path / "docs").mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["merge", str(log)] + legs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert mod.main() == 0
        assert merge_flagship_legs.main([str(log)] + legs + ["--output",
                                                             str(tmp_path / "m.json")]) == 0
    theirs = json.loads((tmp_path / "docs" / "train_flagship3.json").read_text())
    ours = json.loads((tmp_path / "m.json").read_text())
    rt, ro = theirs.pop("bt_ratings"), ours.pop("bt_ratings")
    assert ours == theirs
    assert ours["sources"] == {"leg1.log": 2, "train_flagship2_leg2.json": 27,
                               "train_flagship2_leg3.json": 27}
    assert rt.keys() == ro.keys() and all(abs(rt[k] - ro[k]) <= 1e-6 for k in rt)
    ours, theirs = (matplotlib.image.imread(str(p)) for p in (
        tmp_path / "m_elo.png", tmp_path / "docs" / "train_flagship3_elo.png"))
    assert ours.shape == theirs.shape and np.array_equal(ours, theirs)


@pytest.mark.parametrize("n_boards,size,seed", [(8, 9, 3), (4, 11, 5)])
def test_fuzz_renju_counts_equal_jax(n_boards, size, seed, monkeypatch, capsys):
    """The same boards, the same FIVE/OTHER counts by class, line for line."""
    spec = importlib.util.spec_from_file_location(
        "fuzz_jax", os.path.join(REPO, "tools", "fuzz_renju.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["fuzz_renju.py", str(n_boards), str(size), str(seed)])
    mod.main()
    theirs = capsys.readouterr().out
    res = fuzz_renju.main([str(n_boards), str(size), str(seed), "--device", "cpu"])
    ours = capsys.readouterr().out
    assert ours == theirs
    assert res["cells"] > 0 and res["boards"] == n_boards


def test_smoke_records_phase_stamps_each_record_once(monkeypatch):
    """``chip_smoke.phase_records`` compares the native encoder's bytes with
    ``json``'s; records without a timestamp read the clock at each
    encoding, so the phase stamps them once and a clock that ticks between
    the two encodings does not split them."""
    from types import SimpleNamespace

    import time

    from alphazero_tpu_torch import native
    from alphazero_tpu_torch.games.gomoku import GomokuEnv

    assert native.get_azrecord() is not None, "g++ could not build the encoder"
    env = GomokuEnv(board_size=7)
    T, B = 3, 4
    rng = np.random.RandomState(0)
    out = SimpleNamespace(
        actions=torch.from_numpy(rng.randint(0, 49, (T, B)).astype(np.int32)),
        policies=torch.from_numpy(rng.dirichlet(np.ones(49), (T, B)).astype(np.float32)),
        root_values=torch.from_numpy(rng.uniform(-1, 1, (T, B)).astype(np.float32)),
        active=torch.ones(T, B, dtype=torch.bool),
        winner=torch.tensor([0, 1, -1, 0], dtype=torch.int32))
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *a: "2026-01-01T00:00:%02d" % (next(ticks) % 60))
    res = chip_smoke.phase_records(env, out, games=B)
    assert res["bytes_equal"] and res["records"] == B
