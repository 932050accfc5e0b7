"""Share of the traced slice's wall time in which the device was idle while
the submitting thread was inside a dispatch's ``stream.submit`` span (the
program's spans placed on the trace's clock, portbench/program_spans.py),
in %: idle time that the host's submission holds the device back by."""

from portbench import trace
from portbench.program_spans import overlap_us, placed


def read(run):
    sl = run.slice
    submits = placed(run, "stream.submit")
    if sl is None or submits is None or sl.wall_s <= 0:
        return None
    clipped = trace._union([(max(s, sl.t0), min(e, sl.t1)) for s, e in submits])
    return 100.0 * overlap_us(sl.gaps(), clipped) * 1e-6 / sl.wall_s
