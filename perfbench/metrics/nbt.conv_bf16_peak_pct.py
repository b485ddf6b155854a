"""Kernel layer: the nested-bottleneck trunk's convs (``eval.nbt.conv``
spans) as a share of the bf16 peak: their FLOPs a position
(``yardstick_nbt.trunk_conv_macs``, twice) times the positions evaluated
in the traced steps, over the device time of the activities launched
inside those spans.  Nothing where the run recorded no nbt spans, or the
conv spans are not ``yardstick_nbt.trunk_convs``' count a call."""
from perfbench import yardstick


def read(s):
    j = s.get("nbt")
    if not j or not j["conv_s"] or not s["positions"]:
        return None
    if j["conv_spans"] != j["convs_per_call"] * j["eval_calls"]:
        return None
    flops = j["conv_flops_per_position"] * s["positions"]
    return 100.0 * flops / j["conv_s"] / yardstick.PEAK_OPS["bf16"]
