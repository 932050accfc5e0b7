"""The host's launch of a dispatch in the untraced window: the program's
``step.launch`` spans (the graph's input copies and its replay;
``runtime/tracker.py`` ``_advance``), their seconds over the window's
dispatches, in ms."""

from portbench.program_spans import window_ms


def read(run):
    return window_ms(run, "step.launch")
