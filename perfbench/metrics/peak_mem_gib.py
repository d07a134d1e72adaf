"""The card's peak of allocated memory in the window (GiB), the peak reset
after set-up."""


def read(obs):
    b = obs.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
