"""K1, the workset ring's fused gate (``csrc/cosine_gate.cu``): one call
gathers a ring slot, takes each row's cosine against the ad-hoc rows,
floors it at cos ξ and, for Party A, scales the cached ∇Z into the
cotangent.  A frozen copy of ``kernels/jobs.py::gate_costs``: about 7
operations an element of the (B, F) rows; the fp32 ad-hoc rows read, one
slot of each ring read, the weights written, and for Party A the fp32
cotangent written.

A call is one ``cosine_gate_kernel`` launch (rows of up to one block's
reach) or a ``gate_partials_kernel`` and a ``gate_apply_kernel`` launch
(the split-row path for few wide rows)."""

PATTERNS = ("cosine_gate_kernel", "gate_partials_kernel",
            "gate_apply_kernel")
CALL_PATTERNS = ("cosine_gate_kernel", "gate_partials_kernel")


def cost(B: int, F: int, ring_itemsize: int, cotangent: bool):
    """(operations, bytes) of one call over (B, F) rows; ``cotangent``:
    Party A's call (the z and ∇Z slots read, the cotangent written), else
    Party B's weights-only call (the ∇Z slot read)."""
    rows = B * F
    nbytes = 4 * rows + ring_itemsize * rows + 4 * B
    if cotangent:
        nbytes += ring_itemsize * rows + 4 * rows
    return 7 * rows, nbytes
