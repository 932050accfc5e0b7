"""The whole step's share of the card's bf16 peak: the step's matmul FLOPs
a frame (the model family's flops_per_frame) times the feed-frames the card
stepped in the slice's dispatches, over the slice's seconds and 989
TFLOP/s, in %."""

from portbench.counts import PEAK_BF16_FLOPS


def read(run):
    sl = run.slice
    if sl is None or not sl.dispatches or sl.wall_s <= 0:
        return None
    return 100.0 * run.flops_per_frame * sl.dispatches * run.feeds / sl.wall_s / PEAK_BF16_FLOPS
