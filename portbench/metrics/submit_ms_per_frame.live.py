"""submit_ms_per_dispatch for the one-feed live cell (a dispatch is a frame)."""

from portbench.readout import submit_ms_per_dispatch


def read(run):
    return submit_ms_per_dispatch(run)
