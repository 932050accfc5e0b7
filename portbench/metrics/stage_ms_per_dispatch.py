"""The submitting thread's staging a dispatch in the untraced window: the
program's ``step.stage`` spans (a host array into a pinned staging slot,
the wait for a slot still in flight included; ``runtime/tracker.py``
``stage``), their seconds over the window's dispatches, in ms."""

from portbench.program_spans import window_ms


def read(run):
    return window_ms(run, "step.stage")
