"""idle_share.serve: the share of the traced window in which no kernel, memset or
copy ran on the card(s), 1 - busy / window averaged over the cards, in %."""


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
