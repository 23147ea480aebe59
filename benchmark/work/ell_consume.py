"""Bytes and operations of one iteration's flow and step passes over B
lanes, from the cell's shapes. The step needs the flow's twist, so the
algorithm makes two passes over the list: each reads the K slot
coordinates of every source point (12 B a slot) and the source point
(12 B); the outputs are a few scalars a lane. Whether the kernel values
are cached between the passes is the implementation's choice and is not
counted. Operations: 44 a slot for the flow (transform 18, distance 8,
exp, gates, moments) and 110 for the step's quartic terms."""

FLOW_OPS_PER_SLOT = 44
STEP_OPS_PER_SLOT = 110


def work(n_points: int, k: int, lanes: int):
    nbytes = lanes * 2 * (k * n_points * 12 + n_points * 12)
    ops = lanes * k * n_points * (FLOW_OPS_PER_SLOT + STEP_OPS_PER_SLOT)
    return nbytes, ops
