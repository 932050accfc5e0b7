"""Device busy time a dispatch in the traced slice: the union of kernel and
copy intervals over the slice's graph launches, in ms."""

from portbench.readout import device_ms_per_dispatch


def read(run):
    return device_ms_per_dispatch(run)
