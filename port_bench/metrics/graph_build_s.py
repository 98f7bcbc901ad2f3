"""Seconds from the first draw of the graph to the program's adjacency
ready on the device (the band and its quantized and transposed copies, or
the sampler's CSR), by the benchmark's span around its calls into the
program, ending in a synchronize.  Moves ``setup_s``."""


def read(run):
    return run.spans.get("graph_build_s")
