"""Kernel layer: the least time of every ``gather_rows`` /
``gather_rows_many`` launch of the traced steps (``yardstick.gather_cost``
at the memory bandwidth) over the device time of its kernel.  Nothing where
no launch was made or the launches and the traced kernels do not pair
up."""
from perfbench import yardstick

KERNEL = "gather_rows_kernel"


def read(s):
    launches = s["launches"].gather
    if not launches:
        return None
    names = [n for n in s["kernel_s"] if KERNEL in n]
    if sum(s["kernel_count"][n] for n in names) != len(launches):
        return None
    least = sum(yardstick.least_time(*yardstick.gather_cost(*x), "int8")
                for x in launches)
    busy = sum(s["kernel_s"][n] for n in names)
    return 100.0 * least / busy if busy else None
