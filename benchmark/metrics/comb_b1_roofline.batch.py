"""comb_b1_roofline.batch: the comb kernel B1's share of its byte
roofline, %."""

from benchmark.harness import readers


def read(layer):
    return readers.b1_roofline(layer)
