"""K7, the fused AdaGrad step (``csrc/fused_adagrad.cu``): one launch
updates a table of a party's tensors in place.  A frozen copy of
``kernels/fused_adagrad.py::k7_costs``: 8 operations an element; the
gradient and the accumulator read, the accumulator written, the
parameter read and written, and the step's 4-byte scale read."""

PATTERNS = ("fused_adagrad_kernel",)


def cost(leaves):
    """(operations, bytes) of one party update; ``leaves``: (elements,
    gradient bytes an element, accumulator bytes, parameter bytes)."""
    n = sum(x[0] for x in leaves)
    nbytes = 4 + sum(e * (g + 2 * a + 2 * p) for e, g, a, p in leaves)
    return 8 * n, nbytes
