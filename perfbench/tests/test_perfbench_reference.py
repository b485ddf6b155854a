"""The plain reference against the program at tiny sizes on the CPU: env
rules and observations move by move, the net's forward pass, and whole
runs whose searches the replay reproduces exactly."""
import numpy as np
import pytest
import torch

from perfbench.reference import go as ref_go
from perfbench.reference import gomoku as ref_gomoku
from perfbench.reference import net as ref_net
from perfbench.tests import tiny
from perfbench.weights import make as make_weights, net_shapes


def _program_env(game, n):
    from alphazero_tpu_torch.core import registry

    return registry.create_game(game, n)


def _play_random(game, plain, n, lanes, plies, seed):
    """Random legal games, the program's env batched, the plain one lane by
    lane; every position compared."""
    env = _program_env(game, n)
    gen = torch.Generator().manual_seed(seed)
    st = env.init(lanes, device="cpu")
    ref = [plain.init() for _ in range(lanes)]
    checked = 0
    for _ in range(plies):
        legal = env.legal_mask(st)
        for b in range(lanes):
            assert np.array_equal(legal[b].numpy(), plain.legal(ref[b]))
            obs = env.observation(st)[b].float().numpy()
            assert np.array_equal(obs, plain.observation(ref[b]))
            assert bool(st.terminal[b]) == ref[b].terminal
            assert int(st.winner[b]) == ref[b].winner
            checked += 1
        probs = legal.float() + (~legal.any(1, keepdim=True)).float()
        act = torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
        st = env.step(st, act)
        ref = [plain.step(r, int(a)) if not r.terminal else r
               for r, a in zip(ref, act)]
    return checked


def test_gomoku_rules_and_planes():
    assert _play_random("gomoku", ref_gomoku.Gomoku(7), 7, 6, 40, 3) == 240


def test_go_rules_and_planes_with_captures_and_ko():
    # Random legal play on 5x5 captures and makes ko points within 60 plies.
    plain = ref_go.Go(5)
    assert _play_random("go", plain, 5, 6, 60, 4) == 360
    # A ko: white 6 is captured by black 7; white may not retake at once.
    env = _program_env("go", 5)
    st = env.init(1, device="cpu")
    s = plain.init()
    for a in (1, 2, 5, 8, 11, 12, 24, 6, 7):
        s = plain.step(s, a)
        st = env.step(st, torch.tensor([a], dtype=torch.int32))
    assert s.board.flat[6] == -1 and s.board.flat[7] == 0 and s.ko_point == 6
    assert int(st.ko_point[0]) == 6
    assert not plain.is_legal(s, 6) and not bool(env.legal_mask(st)[0, 6])
    assert np.array_equal(env.observation(st)[0].float().numpy(),
                          plain.observation(s))


def test_net_forward_matches_the_program_float32():
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig

    cfg = ResNetConfig(num_blocks=2, channels=16, policy_channels=4,
                       value_channels=4, value_hidden=16)
    model = AZResNet(50, cfg, (11, 7, 7))
    w = make_weights(net_shapes(model), 123, "cpu")
    model.load_state_dict(w, strict=False)
    obs = torch.rand(10, 11, 7, 7)
    lg, v = ref_net.forward(w, obs, 2)
    lp, vp = model.float()(obs)
    assert torch.allclose(lg, lp, atol=1e-4) and torch.allclose(v, vp, atol=1e-5)
    assert lg.std() > 0.1 and v.std() > 0.01  # live heads
    l4, v4 = ref_net.forward(w, obs, 2, bits=4)
    assert (l4 - lg).abs().max() > 10 * (lp - lg).abs().max()


@pytest.mark.parametrize("game", ["gomoku", "go"])
@pytest.mark.parametrize("seed", [5, 2 ** 33 + 7])
def test_runs_reproduce_exactly(game, seed):
    r = tiny.run(game, seed=seed)
    assert r["correct"], r["checks"]
    c = r["checks"]
    assert c["env_mismatch"]["value"] == 0
    assert c["search_visit_mismatch"]["value"] == 0
    assert c["search_move_mismatch"]["value"] == 0
    assert r["info"]["search_lanes"] >= 3 and r["info"]["rows_compared"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"selfplay_moves_per_s", "setup_s"}
