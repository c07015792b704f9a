"""mfu.batch: the whole call's share of the card's peak, %: the call's
FLOPs, counted from shapes, each part at the peak of the arithmetic the
configuration states, over the call's host seconds in the window."""

from benchmark.harness import readers


def read(layer):
    return readers.mfu(layer)
