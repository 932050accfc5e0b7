"""Median over the frames due in the window of the time from a frame's due
time on the camera's schedule to its record at ``on_record`` (open-loop
cells)."""

from portbench.readout import latency_percentile_ms


def read(run):
    return latency_percentile_ms(run, 50)
