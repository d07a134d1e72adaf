"""Share (%) of the traced window in which no operation ran on the card:
1 - the union of the profiler's device event ranges / the window."""


def read(obs):
    if not obs["busy_s"] or obs["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])
