"""Bytes the SGM path recurrences of one StereoSGBM 3WAY frame need, from
the cell's shapes: the matched columns are W - D (cv2's width1), and each
of the three paths (top to bottom, left to right, right to left) reads the
H x (W - D) x D block-cost volume once and writes its path costs once,
4 B an element each way. Operations are integer minima and adds, not
counted against the float rate: the bytes bind."""

PATHS = 3


def work(rows: int, cols: int, max_disparity: int):
    return PATHS * rows * (cols - max_disparity) * max_disparity * 8, 0
