"""The port's Go env against the JAX package, exactly (tolerance 0).

Random playouts chosen with numpy at 5, 9, 13 and 19, stepped under area
or territory scoring, integer komi among them so that draws occur: every
state field after every step, the legal mask (from the stats ``step`` kept
on its state and from a fresh copy), the observation bit for bit, both
rule sets' scores with and without dead stones, territory ownership, the
position-hash lanes and the arena-row round trip.  Each configuration
compiles the JAX functions once (``jax_fns``), and the cases share one.  Then the group
statistics against ``_cell_group_stats`` (a serpentine group among the
boards), a superko refusal by the ring alone, and the cases of
``tests/test_go.py`` replayed on both packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.core.types import GameType as JaxGameType
from alphazero_tpu.games import go as jgo
from alphazero_tpu_torch.core import registry, zobrist
from alphazero_tpu_torch.core.types import GameType
from alphazero_tpu_torch.games import go
from test_torch_core_gomoku import _pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("board", "to_play", "ko_point", "consecutive_passes", "move_count",
          "prisoners", "terminal", "winner", "board_hash", "history",
          "last_move")


def envs(n, **kw):
    """(JAX env, port env) of one configuration."""
    return jgo.GoEnv(board_size=n, **kw), go.GoEnv(board_size=n, **kw)


@functools.lru_cache(maxsize=None)
def jax_fns(jenv):
    """The JAX env's step and one probe of everything else (the scores
    under both rule sets), jitted and vmapped once per configuration."""
    other = dataclasses.replace(jenv, chinese_rules=not jenv.chinese_rules)

    def probe(s, dead):
        return dict(legal=jenv.legal_mask(s), obs=jenv.observation(s),
                    hash=jenv.position_hash(s), score=jenv.score(s),
                    score_dead=jenv.score(s, dead), score_other=other.score(s),
                    score_other_dead=other.score(s, dead),
                    own=jenv.territory_ownership(s))

    return jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(probe))


def jax_init(jenv, B):
    return jax.vmap(lambda _: jenv.init())(jnp.arange(B))


def to_jax(st: go.GoState) -> jgo.GoState:
    """A port state as a batched JAX state (hash lanes as u32)."""
    kw = {f: jnp.asarray(getattr(st, f).numpy()) for f in FIELDS}
    kw["board_hash"] = kw["board_hash"].astype(jnp.uint32)
    kw["history"] = kw["history"].astype(jnp.uint32)
    return jgo.GoState(**kw)


def assert_state_equal(tst: go.GoState, jst, where=""):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(tst, f).numpy(), np.asarray(getattr(jst, f)).astype(
                np.int64 if f in ("board_hash", "history") else None),
            err_msg=f"{f} {where}")


def assert_probe_equal(tenv, tst, want, dead, where=""):
    """legal mask, observation, position hash, scores and ownership of
    ``tst`` equal the JAX probe ``want``; the mask and the observation from
    the kept stats and from a fresh copy of the state alike."""
    fresh = tst.map(lambda x: x.clone())
    for s in (tst, fresh):
        np.testing.assert_array_equal(tenv.legal_mask(s).numpy(),
                                      np.asarray(want["legal"]), err_msg=where)
        np.testing.assert_array_equal(
            tenv.observation(s).view(torch.int16).numpy(),
            np.asarray(want["obs"]).view(np.int16), err_msg=where)
    np.testing.assert_array_equal(_pair(tenv.position_hash(tst)),
                                  np.asarray(want["hash"]), err_msg=where)
    other = dataclasses.replace(tenv, chinese_rules=not tenv.chinese_rules)
    dead = torch.from_numpy(dead)
    for key, got in (("score", tenv.score(tst)),
                     ("score_dead", tenv.score(tst, dead)),
                     ("score_other", other.score(tst)),
                     ("score_other_dead", other.score(tst, dead))):
        for g, w in zip(got, want[key]):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{key} {where}")
    np.testing.assert_array_equal(tenv.territory_ownership(tst).numpy(),
                                  np.asarray(want["own"]), err_msg=where)


def choose(rng, legal: np.ndarray, p_pass: float) -> np.ndarray:
    """A legal action a lane: pass with probability ``p_pass`` (or when
    nothing else is legal), else a uniform legal point; 0 on terminal
    lanes (which step must ignore)."""
    acts = np.zeros(legal.shape[0], np.int32)
    for b, row in enumerate(legal):
        points = np.flatnonzero(row[:-1])
        if not row[-1]:
            continue
        acts[b] = (len(row) - 1 if rng.rand() < p_pass or not len(points)
                   else rng.choice(points))
    return acts


def play_both(n, kw, B, plies, p_pass, seed, check_every=1):
    """Random playouts on both packages, compared after every step (the
    probe every ``check_every`` plies and at the end).  Returns the
    counters of what the playouts met."""
    jenv, tenv = envs(n, **kw)
    jstep, jprobe = jax_fns(jenv)
    rng = np.random.RandomState(seed)
    jst, tst = jax_init(jenv, B), tenv.init(B, device="cpu")
    seen = dict(ko=0, captures=0, terminal=0, draws=0, move_limit=0)
    for ply in range(plies + 1):
        dead = rng.rand(B, n, n) < 0.1
        if ply % check_every == 0 or ply == plies:
            want = jprobe(jst, jnp.asarray(dead))
            assert_probe_equal(tenv, tst, want, dead, where=f"ply {ply}")
            legal = np.asarray(want["legal"])
        else:
            legal = tenv.legal_mask(tst).numpy()
        if ply == plies:
            break
        acts = choose(rng, legal, p_pass)
        prev_pris = tst.prisoners.sum()
        jst = jstep(jst, jnp.asarray(acts))
        tst = tenv.step(tst, torch.from_numpy(acts))
        assert_state_equal(tst, jst, where=f"ply {ply}")
        seen["ko"] += int((tst.ko_point >= 0).sum())
        seen["captures"] += int(tst.prisoners.sum() - prev_pris)
        rows = tenv.arena_rows(tst)
        assert rows[0].dtype == torch.int8 and rows[1].dtype == torch.int32
        assert_state_equal(tenv.from_arena_rows(*rows), jst, "arena rows")
    seen["terminal"] = int(tst.terminal.sum())
    seen["draws"] = int((tst.terminal & (tst.winner < 0)).sum())
    seen["move_limit"] = int((tst.move_count == tenv.move_limit).sum())
    return seen


ENV5 = dict(komi=0.0)
ENV9 = dict(komi=7.5, chinese_rules=False)
PLAYOUTS = [
    # (n, env kwargs, lanes, plies, pass probability, probe every)
    (5, ENV5, 32, 52, 0.08, 1),
    (9, ENV9, 16, 120, 0.04, 2),
    (13, dict(komi=6.0), 8, 140, 0.02, 10),
    (19, dict(komi=7.0, chinese_rules=False, max_moves=120), 6, 122, 0.01, 20),
]


@pytest.mark.parametrize("n,kw,B,plies,p_pass,every", PLAYOUTS)
def test_random_playouts_match_jax(n, kw, B, plies, p_pass, every):
    seen = play_both(n, kw, B, plies, p_pass, seed=n * 7 + B, check_every=every)
    assert seen["captures"] > 0
    if n == 5:
        assert seen["ko"] > 0 and seen["terminal"] == B and seen["draws"] > 0
        assert 0 < seen["move_limit"] < B  # two passes end the others
    if n == 19:
        assert seen["move_limit"] == B


def test_zobrist_lanes_match_jax():
    jenv, tenv = envs(9)
    piece, player, feature = tenv._lanes("cpu")
    np.testing.assert_array_equal(piece.movedim(0, -1).numpy(),
                                  np.asarray(jenv.zobrist.piece))
    np.testing.assert_array_equal(player.T.numpy(), np.asarray(jenv.zobrist.player))
    np.testing.assert_array_equal(feature.T.numpy(),
                                  np.asarray(jenv.zobrist._feature[0]))
    assert int(piece.max()) <= zobrist.LANE_MASK and int(piece.min()) >= 0
    h = torch.tensor([-5, 7, 2**40 + 3])
    assert torch.equal(zobrist.pack_lanes(*zobrist.split_key(h)), h)


def _serpentine(n):
    grid = np.zeros((n, n), bool)
    grid[0::2, :] = True
    for r in range(1, n, 2):
        grid[r, (n - 1) if (r // 2) % 2 == 0 else 0] = True
    return grid


def _stat_boards(n, rng):
    """Boards of -1/0/1: random densities, a serpentine black group with
    white in its bends, one colour everywhere, and an empty board."""
    boards = [rng.choice([-1, 0, 1], size=(n, n), p=[p, (1 - p) / 2, (1 - p) / 2])
              for p in (0.1, 0.3, 0.5, 0.8)]
    snake = np.where(_serpentine(n), 0, 1).astype(np.int8)
    snake[n // 2, n // 2] = -1 if snake[n // 2, n // 2] == 1 else snake[n // 2, n // 2]
    boards += [snake, np.zeros((n, n)), np.full((n, n), -1)]
    return np.stack(boards).astype(np.int8)


@pytest.mark.parametrize("n", [5, 9, 19])
def test_group_stats_match_jax(n):
    rng = np.random.RandomState(n)
    boards = _stat_boards(n, rng)
    S = n * n
    keys = rng.randint(0, 2**32, size=(S, 2), dtype=np.uint64).astype(np.uint32)
    stats = jax.jit(jax.vmap(jgo._cell_group_stats, in_axes=(0, 0, None)))
    tb = torch.from_numpy(boards)
    k0 = torch.from_numpy(keys[:, 0].astype(np.int64))
    k1 = torch.from_numpy(keys[:, 1].astype(np.int64))
    for colour in (0, 1):
        stones = boards == colour
        want = stats(jnp.asarray(stones.reshape(-1, S)),
                     jnp.asarray((boards == -1).reshape(-1, S)), jnp.asarray(keys))
        ids = go.group_labels(tb == colour)
        got = go.group_stats(ids, (tb == -1).view(-1, S), k0, k1, n)
        for f in ("ids", "libs", "libpos", "size", "keysum"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
    snake = go.group_labels(torch.from_numpy(_serpentine(n))[None])[0]
    assert (snake[torch.from_numpy(_serpentine(n)).view(-1)] == 0).all()


def test_superko_refusal_by_the_ring_alone():
    """A move whose resulting board hash sits in the ring is refused (and
    nothing else refuses it), by both packages alike."""
    jenv, tenv = envs(9, **ENV9)
    jstep, jprobe = jax_fns(jenv)
    rng = np.random.RandomState(5)
    B = 16  # the 9x9 playout's lanes: the same compiled JAX functions
    st = tenv.init(B, device="cpu")
    for _ in range(30):
        st = tenv.step(st, torch.from_numpy(choose(rng, tenv.legal_mask(st).numpy(), 0.0)))
    legal = tenv.legal_mask(st)
    acts = torch.from_numpy(choose(rng, legal.numpy(), 0.0))
    after = tenv.step(st, acts)
    hist = st.history.clone()
    hist[:, 3] = after.board_hash  # as if that board had been seen
    st2 = dataclasses.replace(st, history=hist)
    dead = np.zeros((B, 9, 9), bool)
    want = jprobe(to_jax(st2), jnp.asarray(dead))
    assert_probe_equal(tenv, st2, want, dead)
    refused = tenv.legal_mask(st2)
    assert not refused.gather(1, acts.long()[:, None]).any()
    assert torch.equal(refused | torch.nn.functional.one_hot(acts.long(), 82).bool(),
                       legal)


def rc(n, r, c):
    return r * n + c


def _wall(n=5):
    moves = []
    for r in range(n):
        moves += [rc(n, r, 2), rc(n, r, 4)]
    return moves


KO = [rc(5, 0, 1), rc(5, 0, 2), rc(5, 1, 0), rc(5, 1, 3), rc(5, 2, 1),
      rc(5, 2, 2), rc(5, 4, 4), rc(5, 1, 1)]
JAX_CASES = {
    # The move sequences of tests/test_go.py, on 5x5 (one env for all; the
    # probe scores both rule sets).
    "single_capture": [1, 6, 5, 24, 7, 23, 11],
    "group_capture": [1, 6, 2, 7, 5, 24, 11, 23, 12, 22, 8],
    "corner_capture": [1, 0, 5],
    "capture_restores_liberties": [0, 1, 5, 6, 24, 10],
    "suicide": [24, 1, 18, 5],
    "multi_stone_suicide": [0, 1, 24, 6, 18, 10],
    "capture_on_no_liberty_point": [6, 1, 2, 5, 10, 24, 0],
    "eye_fill": [1, 24, 5, 23, 6, 19, 0],
    "ko_capture_and_ban": KO + [rc(5, 1, 2)],
    "ko_clears_after_tenuki": KO + [rc(5, 1, 2), rc(5, 4, 0), rc(5, 3, 0),
                                    rc(5, 1, 1)],
    "pass_resets": [25, 6, 25, 18],
    "wall_two_passes": _wall() + [25, 25],
    "wall_dead_stones": _wall() + [10],
    "moves_after_the_end": [12, 25, 25, 6, 7],
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_suite_cases_match(case):
    moves = JAX_CASES[case]
    jenv, tenv = envs(5, **ENV5)
    jstep, jprobe = jax_fns(jenv)
    B = 32  # the 5x5 playout's lanes: the same compiled JAX functions
    jst, tst = jax_init(jenv, B), tenv.init(B, device="cpu")
    dead = np.zeros((B, 5, 5), bool)
    dead[:, 0, 4] = True
    for i, m in enumerate(moves):
        a = np.full(B, m, np.int32)
        jst, tst = jstep(jst, jnp.asarray(a)), tenv.step(tst, torch.from_numpy(a))
        assert_state_equal(tst, jst, where=f"{case} move {i}")
        assert_probe_equal(tenv, tst, jprobe(jst, jnp.asarray(dead)), dead,
                           where=f"{case} move {i}")


def test_registry_creates_go():
    env = registry.create_game("go", 9)
    assert isinstance(env, go.GoEnv) and env.num_actions == 82
    assert registry.create_game(GameType.GO).board_size == 9
    assert registry.create_game("go", 19, komi=6.5).komi == 6.5
    assert int(env.game_type) == int(JaxGameType.GO)
    assert int(registry.create_game("chess").game_type) == int(JaxGameType.CHESS)
