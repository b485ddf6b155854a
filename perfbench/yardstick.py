"""Peaks of the card and the operations and bytes of the work measured.

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at the 700 W power
limit.  A launch's least time is the larger of its operations over the
peak rate of its precision and its bytes over the memory bandwidth, with
every input byte read once and every output byte written once.
"""
from __future__ import annotations

PEAK_OPS = {
    "int8": 1979e12,  # TOP/s
    "bf16": 989e12,  # FLOP/s
}
PEAK_BYTES = 3.35e12  # bytes/s of HBM3


def least_time(ops: float, nbytes: float, precision: str) -> float:
    return max(ops / PEAK_OPS[precision], nbytes / PEAK_BYTES)


def s8_mm_cost(M: int, K: int, N: int):
    """(ops, bytes) of ``a [M, K] @ b [K, N]``, s8 x s8 -> s32."""
    return 2 * M * K * N, M * K + K * N + 4 * M * N


def gather_cost(rows: int, row_bytes, index_bytes: int):
    """(ops, bytes) of gathering ``rows`` rows from each arena of row size
    ``row_bytes`` (one index of ``index_bytes`` a row): the index read
    once, every gathered row read once and written once."""
    return 0, rows * index_bytes + 2 * rows * sum(row_bytes)


def resnet_macs(net: dict, channels_in: int, height: int, width: int,
                actions: int) -> int:
    """Multiply-adds of one position through the SE-ResNet: the stem, two
    3x3 convs and the SE gate a block, and both heads."""
    hw = height * width
    c = net["channels"]
    macs = channels_in * c * 9 * hw
    block = 2 * c * c * 9 * hw + 2 * c * (c // net["se_ratio"])
    macs += net["num_blocks"] * block
    pc, vc = net["policy_channels"], net["value_channels"]
    macs += c * pc * hw + pc * hw * actions
    macs += c * vc * hw + vc * hw * net["value_hidden"] + net["value_hidden"]
    return macs
