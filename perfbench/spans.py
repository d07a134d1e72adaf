"""
The program's own recording of a traced window, for the readers of the
metrics that read the port's spans and counters
(libdmet_preview_tpu_torch.utils.timer): the adapter's instrument opens
timer.recording() around the window, so once the window has closed
timer.last() is its recording.
"""


def window(obs):
    """The window's timer.Recording, or None where the observations count
    no iterations or the program keeps no such recording."""
    if not obs.get("iterations"):
        return None
    from libdmet_preview_tpu_torch.utils import timer
    last = getattr(timer, "last", None)
    return None if last is None else last()
