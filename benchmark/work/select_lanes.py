"""Bytes and operations the K-nearest selection of a list build needs, from
the cell's shapes: each lane reads its N source points with their search
radius (16 B each), its M moved target points (12 B each) and its pose
(48 B), and writes K slots a source point (an int32 index and three f32
coordinates) and an int32 count. Operations are not counted: how many
candidates a pool holds depends on the data, and the bytes bind."""


def work(n_source: int, n_target: int, k: int, lanes: int):
    per_lane = n_source * 16 + n_target * 12 + 48 + k * n_source * 16 + n_source * 4
    return lanes * per_lane, 0
