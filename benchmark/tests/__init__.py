"""CPU tests of the benchmark; the card's are marked ``requires_cuda``."""
