"""The port's arena, anchors and evaluation CLIs.

Against JAX on the CPU at 7x7, temperature 0, no opening plies and no root
noise (the two packages' random streams cannot be matched), with at most 32
simulations so no non-root child passes 256 visits (the JAX wave path reads
child stats through bf16): per-lane winners, colours and tallies equal.  At
W > 1 the evaluators have zero value (non-integral value sums read through
bf16 are inexact in JAX); at W = 1 the stub's value noise is matched bit for
bit.  Then the port's own invariants, the anchors, the flagship's tactics
and the two CLIs."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.eval import anchors as janchors
from alphazero_tpu.eval import arena as jarena
from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu_torch.eval import anchors, arena
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from test_torch_search import evaluators, peaked_evaluators
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 7
A = N * N
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models_zoo", "flagship_gomoku15")


def _eval_pair(kind):
    """(jax, torch) evaluators: "noise" the stub with value noise 0.1,
    "zero" the stub with value 0, "peaked" low actions preferred."""
    if kind == "peaked":
        return peaked_evaluators(A)
    return evaluators(A, 0.1 if kind == "noise" else 0.0)


def _same_result(jres, tres):
    np.testing.assert_array_equal(tres.winner.numpy(), np.asarray(jres.winner))
    np.testing.assert_array_equal(tres.a_is_black.numpy(), np.asarray(jres.a_is_black))
    assert (int(tres.wins_a), int(tres.wins_b), int(tres.draws)) == (
        int(jres.wins_a), int(jres.wins_b), int(jres.draws))


@pytest.mark.parametrize("kind_a,kind_b,sims,wave,games,max_moves", [
    ("noise", "peaked", 16, 1, 8, 49),
    ("zero", "zero", 32, 8, 5, 49),
    ("peaked", "noise", 8, 1, 6, 12),
])
def test_play_match_host_matches_jax(kind_a, kind_b, sims, wave, games, max_moves):
    (ja, ta), (jb, tb) = _eval_pair(kind_a), _eval_pair(kind_b)
    kw = dict(num_simulations=sims, wave_size=wave, dirichlet_epsilon=0.0)
    jres = jarena.play_match_host(
        JaxGomoku(board_size=N), ja, jb, jax.random.key(0),
        jarena.ArenaConfig(mcts=jsearch.MCTSConfig(**kw), max_moves=max_moves,
                           temperature=0.0), games)
    tres = arena.play_match_host(
        GomokuEnv(board_size=N), ta, tb, None,
        arena.ArenaConfig(mcts=tsearch.MCTSConfig(**kw), max_moves=max_moves,
                          temperature=0.0), games, device="cpu")
    _same_result(jres, tres)
    assert tres.winner.shape == (games,)


@pytest.mark.parametrize("side_a,side_b,games", [
    (("zero", dict(num_simulations=24, wave_size=4, tree_reuse=True, reuse_cap=64)),
     ("noise", dict(num_simulations=8, wave_size=1)), 8),
    (("noise", dict(num_simulations=16, wave_size=1, tree_reuse=True, reuse_cap=32,
                    reuse_budget="fixed")),
     ("peaked", dict(num_simulations=32, wave_size=8)), 7),
    (("peaked", dict(num_simulations=12, wave_size=4)),
     ("zero", dict(num_simulations=32, wave_size=16, tree_reuse=True, reuse_cap=64)), 4),
])
def test_play_match_sides_matches_jax(side_a, side_b, games):
    """Each side its own simulation count and wave, one of them with tree
    reuse (advanced through the opponent's moves); 2 * ceil(games / 2)
    lanes."""
    sides = []
    for kind, kw in (side_a, side_b):
        jev, tev = _eval_pair(kind)
        kw = dict(kw, dirichlet_epsilon=0.0)
        sides.append(((jev, jsearch.MCTSConfig(**kw)), (tev, tsearch.MCTSConfig(**kw))))
    jres = jarena.play_match_sides(JaxGomoku(board_size=N), sides[0][0], sides[1][0],
                                   jax.random.key(0), games, max_moves=49, temperature=0.0)
    tres = arena.play_match_sides(GomokuEnv(board_size=N), sides[0][1], sides[1][1],
                                  None, games, max_moves=49, temperature=0.0, device="cpu")
    _same_result(jres, tres)
    assert tres.winner.shape == (2 * ((games + 1) // 2),)


def test_play_match_equals_host_loop_without_openings():
    """``play_match`` (no early exit) and ``play_match_host`` play the same
    games where every game ends before ``max_moves``."""
    env = GomokuEnv(board_size=5)
    _, tev = evaluators(25, 0.1)
    cfg = arena.ArenaConfig(mcts=tsearch.MCTSConfig(num_simulations=8, dirichlet_epsilon=0.0),
                            max_moves=25, temperature=0.0)
    a = arena.play_match(env, tev, make_uniform_eval_fn(25), None, cfg, 6, device="cpu")
    b = arena.play_match_host(env, tev, make_uniform_eval_fn(25), None, cfg, 6, device="cpu")
    assert torch.equal(a.winner, b.winner) and int(a.a_is_black.sum()) == 3


def test_mover_eval_routes_each_lane():
    """With W rows a lane, black to move: lanes [0, half) are A's, the rest
    B's; white to move the other way round; logits and values in f32."""
    B, W, half = 5, 4, 3

    def const(c, dtype):
        def f(obs, to_play):
            n = obs.shape[0]
            return torch.full((n, 2), c, dtype=dtype), torch.full((n,), c, dtype=dtype)
        return f

    obs = torch.zeros(B * W, 1)
    tp = torch.zeros(B * W, dtype=torch.int32)
    lane_is_first = torch.arange(B).repeat_interleave(W) < half
    for black, want_first in ((True, 1.0), (False, 2.0)):
        fn = arena.make_mover_eval_fn(const(1.0, torch.bfloat16), const(2.0, torch.float32),
                                      half, black, num_games=B)
        logits, value = fn(obs, tp)
        want = torch.where(lane_is_first, want_first, 3.0 - want_first)
        assert logits.dtype == value.dtype == torch.float32
        assert torch.equal(value, want) and torch.equal(logits[:, 0], want)
    matchup = arena.make_matchup_eval_fn(const(1.0, torch.float32), const(2.0, torch.float32),
                                         torch.arange(B) < half)
    tp = (torch.arange(B * W) % 2).to(torch.int32)  # black to move on even rows
    _, value = matchup(obs, tp)
    use_a = lane_is_first == (tp == 0)
    assert torch.equal(value, torch.where(use_a, 1.0, 2.0))


def test_openings_mirrored_and_distinct():
    """Host loop: lane i and lane half + i replay one opening, and pairs
    differ.  Sides: both halves start from the same openings."""
    env = GomokuEnv(board_size=N)
    B, half, k = 8, 4, 4
    gen = torch.Generator().manual_seed(3)
    st = env.init(B, device="cpu")
    for _ in range(k):
        acts = arena._opening_actions(env, st, gen, half)
        st = env.step(st, torch.cat([acts, acts[:B - half]]))
    assert torch.equal(st.board[:half], st.board[half:])
    assert not torch.equal(st.board[0], st.board[1])
    assert bool((st.to_play == 0).all()) and bool((st.move_count == k).all())

    seen = []

    def recording(states, generator):
        if int(states.move_count[0]) == k:
            seen.append(states.board.clone())
        return tsearch.search(env, make_uniform_eval_fn(A), states,
                              tsearch.MCTSConfig(num_simulations=4, dirichlet_epsilon=0.0),
                              generator)

    res = arena.play_match_sides(env, recording, recording, torch.Generator().manual_seed(1),
                                 8, max_moves=8, opening_random_moves=k, device="cpu")
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    assert len({tuple(b.flatten().tolist()) for b in seen[0]}) > 1
    assert res.a_is_black.tolist() == [True] * 4 + [False] * 4


def test_color_swap_and_tally():
    env = GomokuEnv(board_size=N)
    cfg = arena.ArenaConfig(mcts=tsearch.MCTSConfig(num_simulations=8, dirichlet_epsilon=0.0),
                            max_moves=16, opening_random_moves=2)
    u = make_uniform_eval_fn(A)
    res = arena.play_match_host(env, u, u, torch.Generator().manual_seed(1), cfg, 7,
                                device="cpu")
    assert res.a_is_black.tolist() == [True] * 4 + [False] * 3
    assert int(res.wins_a) + int(res.wins_b) + int(res.draws) == 7
    winner = torch.tensor([0, 1, -1, 0, 1, 1])
    t = arena._tally(winner, torch.tensor([True, True, True, False, False, False]))
    assert (int(t.wins_a), int(t.wins_b), int(t.draws)) == (3, 2, 1)


def test_anchors_construct_as_jax():
    env, jenv = GomokuEnv(board_size=N), JaxGomoku(board_size=N)
    assert anchors.POOL == janchors.POOL and anchors.CANONICAL == janchors.CANONICAL
    assert anchors.CANONICAL_RATING == janchors.CANONICAL_RATING
    st = env.init(2, device="cpu")
    st = env.step(st, torch.tensor([24, 10]))
    obs = env.observation(st)
    for name in anchors.POOL:
        eval_fn, cfg = anchors.make_anchor(env, name)
        jfn, jcfg = janchors.make_anchor(jenv, name)
        for field in ("num_simulations", "dirichlet_epsilon", "wave_size", "tree_reuse"):
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
        logits, _ = eval_fn(obs, st.to_play)
        jl, _ = jax.jit(jfn)(jnp.asarray(obs.float().numpy(), jnp.bfloat16),
                             jnp.asarray(st.to_play.numpy()))
        assert logits.shape == (2, A)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2.0 ** -23, atol=0)


def test_anchors_raise_as_jax():
    class GoEnv:
        num_actions, board_size = 81, 9

    with pytest.raises(ValueError):
        anchors.make_anchor(GoEnv(), "attack_defense_64")
    with pytest.raises(ValueError):
        anchors.make_anchor(GomokuEnv(board_size=N), "nope")


@pytest.fixture(scope="module")
def flagship():
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    env = GomokuEnv(board_size=15)
    model, _ = load_model(FLAGSHIP, env.observation_shape, device="cpu")
    return env, make_inference_eval_fn(model)


def _flagship_move(env, eval_fn, moves):
    st = env.init(1, device="cpu")
    for r, c in moves:
        st = env.step(st, torch.tensor([r * 15 + c]))
    out = tsearch.search(env, eval_fn, st,
                         tsearch.MCTSConfig(num_simulations=48, dirichlet_epsilon=0.0))
    return int(tsearch.select_action(None, out.visit_counts, 0.0)[0])


def test_flagship_takes_immediate_win(flagship):
    a = _flagship_move(*flagship, [(7, 3), (7, 2), (7, 4), (0, 0), (7, 5), (1, 0),
                                   (7, 6), (2, 0)])
    assert a == 7 * 15 + 7, a


def test_flagship_blocks_immediate_loss(flagship):
    a = _flagship_move(*flagship, [(7, 3), (7, 2), (7, 4), (0, 0), (7, 5), (1, 0),
                                   (7, 6)])
    assert a == 7 * 15 + 7, a


def _cli_json(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evaluate_cli_matches_jax(capsys, tmp_path):
    """At T 0 with no opening plies the numbers equal JAX's (W=1: the stub's
    value noise is matched bit for bit there); with the default openings,
    the keys."""
    from alphazero_tpu.scripts import evaluate as jcli
    from alphazero_tpu_torch.scripts import evaluate as tcli

    argv = ["--board-size", "7", "--num-games", "4", "--simulations", "8",
            "--wave", "1", "--opening-moves", "0", "--temperature", "0"]
    ours = _cli_json(tcli.main, argv + ["--device", "cpu",
                                        "--elo-file", str(tmp_path / "elo.json")], capsys)
    theirs = _cli_json(jcli.main, argv, capsys)
    assert ours == theirs
    # The Elo file the port wrote loads in the JAX tracker.
    from alphazero_tpu.elo.tracker import EloTracker as JaxTracker

    assert JaxTracker.load(str(tmp_path / "elo.json")).games_played["uniform_a"] == 4
    argv = ["--board-size", "7", "--num-games", "2", "--simulations", "4",
            "--max-moves", "10"]
    assert (_cli_json(tcli.main, argv + ["--device", "cpu"], capsys).keys()
            == _cli_json(jcli.main, argv, capsys).keys())


def test_tournament_cli_keys_match_jax(capsys, tmp_path):
    """Two small 7x7 bundles (written by the JAX package): stdout and the
    --output file carry JAX's keys and players."""
    from alphazero_tpu.models.resnet import AZResNet as JaxResNet
    from alphazero_tpu.models.resnet import ResNetConfig as JaxConfig
    from alphazero_tpu.models.io import save_model
    from alphazero_tpu.scripts import tournament as jcli
    from alphazero_tpu_torch.scripts import tournament as tcli

    cfg = JaxConfig(num_blocks=1, channels=8, se_ratio=4, policy_channels=4,
                    value_channels=4, value_hidden=16)
    zoo = tmp_path / "zoo"
    for i in range(2):
        model = JaxResNet(num_actions=A, cfg=cfg)
        variables = model.init(jax.random.key(i), jnp.zeros((1, 11, N, N)))
        variables = jax.tree_util.tree_map(
            lambda x: x + 0.1 * jax.random.normal(jax.random.key(9 + i), x.shape), variables)
        save_model(str(zoo / f"net{i}.msgpack"), variables, "resnet", A, cfg)
    argv = ["--board-size", "7", "--models-dir", str(zoo), "--games-per-pair", "2",
            "--simulations", "4"]
    ours = _cli_json(tcli.main, argv + ["--device", "cpu", "--output",
                                        str(tmp_path / "ours.json")], capsys)
    theirs = _cli_json(jcli.main, argv + ["--output", str(tmp_path / "theirs.json")], capsys)
    assert ours.keys() == theirs.keys() == {"elo", "bt"}
    for key in ("elo", "bt"):
        assert sorted(r["player"] for r in ours[key]) == sorted(r["player"] for r in theirs[key])
        assert [r.keys() for r in ours[key]] == [r.keys() for r in theirs[key]]
    with open(tmp_path / "ours.json") as f, open(tmp_path / "theirs.json") as g:
        a, b = json.load(f), json.load(g)
    assert a.keys() == b.keys() and len(a["results"]) == len(b["results"]) == 1
    assert [r.keys() for r in a["results"]] == [r.keys() for r in b["results"]]
