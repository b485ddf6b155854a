"""Plots (``utils/visualization.py``): the data helpers on fixed inputs,
and each figure pixel for pixel against the JAX package's from the same
inputs where matplotlib is installed."""
import numpy as np
import pytest

from alphazero_tpu.elo.tracker import EloTracker as JaxTracker
from alphazero_tpu.utils import visualization as jviz
from alphazero_tpu_torch.elo.tracker import EloTracker
from alphazero_tpu_torch.utils import visualization as viz

HISTORY = [{"iteration": 0, "moves": 5},
           {"iteration": 1, "loss": 3.0, "policy_loss": 2.5, "value_loss": 0.5},
           {"iteration": 2, "loss": 2.0, "policy_loss": 1.75, "value_loss": 0.25}]
MATCHES = [("a", "b", 1.0), ("a", "c", 0.5), ("b", "c", 0.0), ("c", "a", 1.0)]
BOARD = np.array([[-1, 0, -1], [1, -1, -1], [-1, -1, 0]])
WEIGHTS = np.array([0.1, 0.0, 0.2, 0.0, 0.3, 0.05, 0.25, 0.1, 0.0, 9.0])


def _tracker(cls):
    t = cls()
    for a, b, s in MATCHES:
        t.add_match_result(a, b, s)
    return t


def test_training_curves():
    its, curves = viz.training_curves(HISTORY)
    assert its == [1, 2]
    assert curves == {"loss": [3.0, 2.0], "policy_loss": [2.5, 1.75],
                      "value_loss": [0.5, 0.25]}


def test_elo_trajectories():
    xs, ratings = viz.elo_trajectories(_tracker(EloTracker))
    assert xs == {"a": [0, 1, 3], "b": [0, 2], "c": [1, 2, 3]}
    # K = 32 from 1500 each: a beats b (+16), a draws c, c beats b, c beats a.
    assert ratings["a"][0] == pytest.approx(1516.0)
    assert ratings["b"][0] == pytest.approx(1484.0)
    assert ratings["a"][1] == pytest.approx(1516.0 + 32 * (0.5 - 1 / (1 + 10 ** (-16 / 400))))
    # The replay ends at the tracker's own ratings.
    t = _tracker(EloTracker)
    for name, r in ratings.items():
        assert r[-1] == pytest.approx(t.get_rating(name))


def test_heat_grid():
    grid, black, white = viz.heat_grid(BOARD, WEIGHTS)
    np.testing.assert_array_equal(grid, WEIGHTS[:9].reshape(3, 3))
    assert black == [(0, 1), (2, 2)] and white == [(1, 0)]


def _pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def test_plots_pixel_equal_jax(tmp_path):
    pytest.importorskip("matplotlib")
    for name, args in (
            ("plot_training_history", lambda mod, trk: (HISTORY,)),
            ("plot_elo_history", lambda mod, trk: (_tracker(trk),)),
            ("plot_board_heatmap", lambda mod, trk: (BOARD, WEIGHTS))):
        ours = str(tmp_path / "port" / f"{name}.png")
        theirs = str(tmp_path / "jax" / f"{name}.png")
        assert getattr(viz, name)(*args(viz, EloTracker), ours) == ours
        getattr(jviz, name)(*args(jviz, JaxTracker), theirs)
        a, b = _pixels(ours), _pixels(theirs)
        assert a.shape == b.shape and np.array_equal(a, b), name


def test_missing_matplotlib_raises_jax_error(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError) as terr:
        viz.plot_training_history(HISTORY, "unused.png")
    with pytest.raises(ImportError) as jerr:
        jviz.plot_training_history(HISTORY, "unused.png")
    assert type(terr.value) is type(jerr.value) and str(terr.value) == str(jerr.value)
