"""K1 (`dense_scan`) at its roofline: the least time of the window's launches
over the kernel's device time in the window, in % (_prefix_roofline.py)."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_prefix_roofline").share(w, "k1")
