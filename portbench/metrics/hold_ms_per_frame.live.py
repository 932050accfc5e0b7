"""How long a record waits in the stream pipeline in the untraced window:
the mean of the program's ``frame.hold`` spans (one a record, from the end
of its dispatch's ``stream.submit`` to its hand-over to ``on_record``:
the readback window and the drainer), in ms."""

from portbench.program_spans import window_ms


def read(run):
    return window_ms(run, "frame.hold", per="span")
