"""The host's noise draws a dispatch in the untraced window: the program's
``step.noise`` spans (a generator and its draws a bank, made on the host's
call outside the step's graph; ``runtime/tracker.py`` ``_advance``), their
seconds over the window's dispatches, in ms."""

from portbench.program_spans import window_ms


def read(run):
    return window_ms(run, "step.noise")
