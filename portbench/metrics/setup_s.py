"""From the process's start to the first timed query: imports, the tables
drawn and built on the card, the kernels built or loaded, the warm-up."""


def read(w):
    return w.setup_s
