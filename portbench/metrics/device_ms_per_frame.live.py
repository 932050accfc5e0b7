"""device_ms_per_dispatch for the one-feed live cell (a dispatch is a frame)."""

from portbench.readout import device_ms_per_dispatch


def read(run):
    return device_ms_per_dispatch(run)
