"""The stream pipeline's host time to ship and enqueue one dispatch
(``runtime/streaming.py`` ``stream_track``: ``submit_s`` over its
dispatches), in ms."""

from portbench.readout import submit_ms_per_dispatch


def read(run):
    return submit_ms_per_dispatch(run)
