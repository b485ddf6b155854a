"""Kernel layer: the least time of every ``s8_mm`` launch of the traced
steps (``yardstick.s8_mm_cost`` at int8's peak and the memory bandwidth)
over the device time of its kernels.  Nothing where no launch was made or
the launches and the traced kernels do not pair up."""
from perfbench import yardstick

KERNELS = {"resident": ("s8_resident_kernel",),
           "tiled": ("wgmma_tiled_kernel", "transpose_s8_kernel")}


def read(s):
    launches = s["launches"].s8_mm
    if not launches:
        return None
    least = sum(yardstick.least_time(*yardstick.s8_mm_cost(M, K, N), "int8")
                for M, K, N, _ in launches)
    routes = {r for *_, r in launches}
    names = [n for n in s["kernel_s"]
             if any(k in n for r in routes for k in KERNELS[r])]
    resident = sum(s["kernel_count"][n] for n in names
                   if "s8_resident_kernel" in n)
    if resident != sum(r == "resident" for *_, r in launches):
        return None
    busy = sum(s["kernel_s"][n] for n in names)
    return 100.0 * least / busy if busy else None
