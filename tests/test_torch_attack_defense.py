"""The port's attack/defense bonuses against ``alphazero_tpu/ops/attack_defense.py``
on seeded boards, and the behaviour cases of ``tests/test_attack_defense.py``.

Tolerance: one rounding of the last weighted sum (relative 2**-23).  The
threat counts and each side's sum are exact on both sides; XLA contracts
``attack_weight * attack + defense_weight * defense`` into one fused
multiply-add whose form depends on the constants (with weight 1.0 it drops
the product), where the port rounds each product, so about one value in
50,000 differs by one ulp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.ops import attack_defense as jad
from alphazero_tpu.models.stub import make_uniform_eval_fn as jax_uniform
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.ops.attack_defense import compute_bonuses, policy_bias_eval_fn
from test_torch_gomoku_variants import _random_boards

ULP = 2.0 ** -23


def board_with(black, white, n=9):
    b = np.full((n, n), -1, np.int8)
    for r, c in black:
        b[r, c] = 0
    for r, c in white:
        b[r, c] = 1
    return torch.from_numpy(b)[None]


@pytest.mark.parametrize("n,weights", [
    (15, {}), (9, {}),
    (15, dict(attack_weight=0.3, defense_weight=1.1, win_bonus=7.0,
              four_weight=2.5, three_weight=0.25)),
])
def test_bonuses_match_jax(n, weights):
    rng = np.random.RandomState(n)
    boards = _random_boards(rng, 256, n, n * n // 3)
    to_play = rng.randint(0, 2, 256).astype(np.int32)
    want = jax.jit(jax.vmap(lambda b, t: jad.compute_bonuses(b, t, **weights)))(
        jnp.asarray(boards), jnp.asarray(to_play))
    got = compute_bonuses(torch.from_numpy(boards), torch.from_numpy(to_play), **weights)
    assert got.dtype == torch.float32 and got.shape == (256, n * n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ULP, atol=0)


def test_policy_bias_eval_fn_matches_jax():
    """The wrapped uniform stub on observations of random positions: the
    board rebuilt from planes 0 and 1 and ``to_play``, logits and values
    as JAX's."""
    n, B = 9, 64
    env = GomokuEnv(board_size=n)
    rng = np.random.RandomState(2)
    st = env.init(B, device="cpu")
    for _ in range(30):
        legal = env.legal_mask(st).numpy()
        acts = np.array([rng.choice(np.flatnonzero(legal[b])) if legal[b].any() else 0
                         for b in range(B)])
        st = env.step(st, torch.from_numpy(acts))
    obs = env.observation(st)
    tfn = policy_bias_eval_fn(make_uniform_eval_fn(n * n, 0.1), n, scale=1.0)
    jfn = jad.policy_bias_eval_fn(jax_uniform(n * n, 0.1), n, scale=1.0)
    tl, tv = tfn(obs, st.to_play)
    jl, jv = jax.jit(jfn)(jnp.asarray(obs.float().numpy(), jnp.bfloat16),
                          jnp.asarray(st.to_play.numpy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=ULP, atol=0)
    assert tl.abs().sum() > 0
    # The value passes through.  The JAX stub compiled alone returns it in
    # the observation's dtype (bf16); the port's keeps the f32 product it
    # feeds the search.
    np.testing.assert_array_equal(tv.to(torch.bfloat16).float().numpy(),
                                  np.asarray(jv).astype(np.float32))


def test_winning_move_highest():
    board = board_with([(0, 0), (0, 1), (0, 2), (0, 3)], [], 9)
    assert int(compute_bonuses(board, torch.tensor([0])).argmax()) == 4


def test_defense_of_opponent_four():
    board = board_with([(0, 0), (0, 1), (0, 2), (0, 3)], [(5, 5)], 9)
    assert int(compute_bonuses(board, torch.tensor([1])).argmax()) == 4


def test_occupied_cells_zero():
    bonus = compute_bonuses(board_with([(4, 4)], [(3, 3)], 9), torch.tensor([0]))[0]
    assert float(bonus[4 * 9 + 4]) == 0.0 and float(bonus[3 * 9 + 3]) == 0.0


def test_batched():
    board = board_with([(0, 0)], [], 9)
    bonuses = compute_bonuses(torch.cat([board, board]), torch.zeros(2, dtype=torch.int32))
    assert bonuses.shape == (2, 81)
