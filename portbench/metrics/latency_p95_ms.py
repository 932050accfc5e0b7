"""95th percentile of the same samples as latency_p50_ms."""

from portbench.readout import latency_percentile_ms


def read(run):
    return latency_percentile_ms(run, 95)
