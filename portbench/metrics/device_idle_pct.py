"""Share of the traced slice's wall time in which no kernel or copy ran on
the device, in %."""


def read(run):
    sl = run.slice
    if sl is None or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
