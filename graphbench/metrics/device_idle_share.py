"""The share of the traced window in which no kernel, copy or memset ran
on the card (1 - the union of device activity / the window)."""


def read(w):
    if w.busy_s is None or w.window_s <= 0:
        return None
    return 1.0 - w.busy_s / w.window_s
