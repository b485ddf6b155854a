"""The port's regression, benchmark and hyperparameter-search scripts
against the JAX package's: the same checks, keys and draws."""
import json
import random

import pytest

from alphazero_tpu.scripts import benchmark as jbenchmark
from alphazero_tpu.scripts import hyperopt as jhyperopt
from alphazero_tpu.scripts import regression_test as jregression
from alphazero_tpu_torch.scripts import benchmark, hyperopt, regression_test
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    return exit_.value.code, _lines(capsys)


def test_regression_test_checks_match_jax(capsys):
    code, ours = _run(regression_test.main,
                      ["--device", "cpu", "--games", "gomoku", "--skip-perf"], capsys)
    jcode, theirs = _run(jregression.main, ["--games", "gomoku", "--skip-perf"],
                         capsys)
    assert code == jcode == 0
    assert [(r.get("check"), r.get("ok")) for r in ours] == \
        [(r.get("check"), r.get("ok")) for r in theirs]
    assert [r["check"] for r in ours[:-1]] == [
        "gomoku.init_step_obs", "gomoku.search", "selfplay.completes",
        "model.forward"]
    assert ours[-1] == theirs[-1] == {"total": 4, "failed": 0}


def test_regression_test_all_games_and_perf_on_cpu(capsys):
    code, ours = _run(regression_test.main, ["--device", "cpu"], capsys)
    assert code == 0 and ours[-1] == {"total": 9, "failed": 0}
    assert [r["check"] for r in ours[:-1]] == [
        "gomoku.init_step_obs", "gomoku.search", "go.init_step_obs", "go.search",
        "chess.init_step_obs", "chess.search", "selfplay.completes",
        "model.forward", "perf.search_floor"]


def test_regression_test_reports_a_failed_check(capsys, monkeypatch):
    from alphazero_tpu_torch.models import resnet

    def broken(*a, **k):
        raise RuntimeError("no net")

    monkeypatch.setattr(resnet, "AZResNet", broken)
    code, ours = _run(regression_test.main,
                      ["--device", "cpu", "--games", "gomoku", "--skip-perf"], capsys)
    assert code == 1 and ours[-1] == {"total": 4, "failed": 1}
    (bad,) = [r for r in ours[:-1] if not r["ok"]]
    assert bad["check"] == "model.forward"
    assert bad["error"] == "RuntimeError: no net" and "trace" in bad


def test_benchmark_keys_match_jax(capsys):
    tiny = ["--batch", "4", "--simulations", "4", "--blocks", "1", "--channels",
            "8", "--board-size", "7"]
    benchmark.main(tiny + ["--device", "cpu"])
    (ours,) = _lines(capsys)
    jbenchmark.main(tiny)
    (theirs,) = _lines(capsys)
    assert list(ours) == list(theirs) == ["nn_inference", "env_step", "search"]
    for k in ours:
        assert list(ours[k]) == list(theirs[k]), k
    assert ours["search"]["simulations"] == 4 and ours["env_step"]["batch"] == 4
    assert ours["search"]["sims_per_s"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_hyperopt_draws_match_jax(seed):
    assert hyperopt.SPACE == jhyperopt.SPACE
    ours, theirs = random.Random(seed), random.Random(seed)
    for _ in range(3):
        assert hyperopt.sample_params(ours) == jhyperopt.sample_params(theirs)


def test_hyperopt_run_writes_jax_schema(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # each trial writes checkpoints/history.json
    out = tmp_path / "results.json"
    hyperopt.main(["--device", "cpu", "--trials", "2", "--iterations", "1",
                   "--board-size", "5", "--games", "20", "--simulations", "4",
                   "--seed", "1", "--output", str(out)])
    assert (tmp_path / "checkpoints" / "history.json").exists()
    lines = _lines(capsys)
    results = json.loads(out.read_text())
    assert len(results) == 2 and lines[-1] == {"best": results[0]}
    assert results[0]["score"] <= results[1]["score"]
    rng = random.Random(1)
    draws = [jhyperopt.sample_params(rng) for _ in range(2)]
    for r in results:
        assert list(r) == ["params", "score"]
        assert list(r["params"]) == list(jhyperopt.SPACE)
        assert r["params"] in draws
        assert isinstance(r["score"], float) and r["score"] < float("inf")
    assert [r["params"] for r in lines[:2]] == draws
