"""Tracked frames (a feed's frame counts one) whose records reached
``on_record`` inside the window, over the window's seconds (closed-loop
cells)."""


def read(run):
    if run.wl["loop"] != "closed":
        return None
    return run.feeds * len(run.in_window()) / run.seconds
