"""Operations of KataGo's nested-bottleneck net (``block: "nbt"``), one
position at a time: the trunk's convs, for the share of the bf16 peak that
``metrics/nbt.conv_bf16_peak_pct.py`` reads, and the whole net's
multiply-adds, which the self-play loop records as ``macs_per_position``.
The peaks are ``yardstick.py``'s."""
from __future__ import annotations


def trunk_convs(net: dict, channels_in: int) -> list:
    """``(in, out, kernel)`` of every trunk conv of one forward pass, in
    order: the stem, then a block's ``conv_p``, its inner blocks' convs
    (``conv_a``, ``conv_b``; a pooling block's ``conv_r``, ``conv_g``,
    ``conv_b``) and ``conv_q``."""
    c = net["channels"]
    m = c // 2  # the inner blocks' width
    g, every = net["gpool_channels"], net["gpool_every"]
    convs = [(channels_in, c, 3)]
    for k in range(net["num_blocks"]):
        convs.append((c, m, 1))
        if every and (k + 1) % every == 0:
            convs += [(m, m - g, 3), (m, g, 3), (m - g, m, 3)]
        else:
            convs += [(m, m, 3), (m, m, 3)]
        convs += [(m, m, 3), (m, m, 3), (m, c, 1)]
    return convs


def trunk_conv_macs(net: dict, channels_in: int, height: int, width: int) -> int:
    return sum(i * o * k * k for i, o, k in trunk_convs(net, channels_in)) * height * width


def net_macs(net: dict, channels_in: int, height: int, width: int,
             actions: int) -> int:
    """Multiply-adds of one position through the whole net: the trunk's
    convs, the poolings' dense layers and both heads."""
    hw = height * width
    c = net["channels"]
    m = c // 2
    g, every = net["gpool_channels"], net["gpool_every"]
    macs = trunk_conv_macs(net, channels_in, height, width)
    pools = sum(1 for k in range(net["num_blocks"]) if every and (k + 1) % every == 0)
    macs += pools * 3 * g * (m - g)
    pc, vc = net["policy_channels"], net["value_channels"]
    macs += c * pc * hw + pc * hw * actions
    macs += c * vc * hw + vc * hw * net["value_hidden"] + net["value_hidden"]
    return macs
