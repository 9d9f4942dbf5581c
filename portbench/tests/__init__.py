"""CPU tests of the benchmark; tests marked `card` run on the card."""
