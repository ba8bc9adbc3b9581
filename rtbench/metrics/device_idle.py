"""The share of the traced window in which no operation ran on the card,
in percent: 100 (1 - busy / window), busy being the union of every kernel,
copy and set on the device timeline."""


def read(r):
    tl = r.timeline
    if tl is None or tl.window_s <= 0.0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
