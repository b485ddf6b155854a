"""Operations and bytes against shapes worked by hand."""
import pytest

from perfbench import yardstick


def test_s8_mm_cost_by_hand():
    # a [512*225, 576] @ b [576, 64]: one 3x3 conv over a 512-position chunk
    M, K, N = 512 * 225, 576, 64
    ops, nbytes = yardstick.s8_mm_cost(M, K, N)
    assert ops == 2 * 115200 * 576 * 64 == 8_493_465_600
    assert nbytes == 115200 * 576 + 576 * 64 + 4 * 115200 * 64 == 95_883_264
    # bound by memory: 95.9 MB / 3.35 TB/s = 28.6 us > 8.49 GOP / 1979 TOP/s
    t = yardstick.least_time(ops, nbytes, "int8")
    assert t == pytest.approx(95_883_264 / 3.35e12)
    assert t == pytest.approx(28.62e-6, rel=1e-3)


def test_gather_cost_by_hand():
    # 1024 lanes x 16 walkers, a 225-byte board row and a 48-byte meta row,
    # int64 indices: 16384 * 8 + 2 * 16384 * 273
    ops, nbytes = yardstick.gather_cost(16384, [225, 48], 8)
    assert ops == 0 and nbytes == 131072 + 8945664
    assert yardstick.least_time(ops, nbytes, "int8") == pytest.approx(
        9076736 / 3.35e12)


def test_least_time_takes_the_larger_bound():
    assert yardstick.least_time(1979e12, 0, "int8") == pytest.approx(1.0)
    assert yardstick.least_time(989e12, 0, "bf16") == pytest.approx(1.0)
    assert yardstick.least_time(1.0, 3.35e12, "bf16") == pytest.approx(1.0)


def test_resnet_macs_by_hand():
    net = dict(num_blocks=6, channels=64, se_ratio=4, policy_channels=32,
               value_channels=32, value_hidden=256)
    # Gomoku 15x15, 11 planes, 225 actions
    stem = 11 * 64 * 9 * 225  # 1,425,600
    block = 2 * 64 * 64 * 9 * 225 + 2 * 64 * 16  # 16,590,848
    policy = 64 * 32 * 225 + 32 * 225 * 225  # 2,080,800
    value = 64 * 32 * 225 + 32 * 225 * 256 + 256  # 2,304,256
    want = stem + 6 * block + policy + value
    assert want == 105_355_744
    assert yardstick.resnet_macs(net, 11, 15, 15, 225) == want
    # Go 9x9, 8 planes, 82 actions
    assert yardstick.resnet_macs(net, 8, 9, 9, 82) == (
        8 * 64 * 81 * 9 + 6 * (2 * 64 * 64 * 9 * 81 + 2 * 64 * 16)
        + 64 * 32 * 81 + 32 * 81 * 82 + 64 * 32 * 81 + 32 * 81 * 256 + 256)


def test_mfu_reader_by_hand():
    from perfbench import harness

    mod = harness.load_module(harness.HERE / "metrics" / "mfu.selfplay.py")
    s = {"positions": 819_200, "window_s": 10.0, "macs_per_position": 105_355_744,
         "precision": "int8"}
    assert mod.read(s) == pytest.approx(
        100 * 2 * 105_355_744 * 819_200 / 10.0 / 1979e12)
    assert mod.read(dict(s, positions=0)) is None
