"""Runtime hyper-parameters for CVO registration.

A copy of `unified_cvo_tpu/config.py` (reference CvoParams.hpp:12-128,
reader :193-303), kept here so the port never imports the JAX package.
Defaults replicate the C++ constructor defaults (CvoParams.hpp:73-128).
"""

from __future__ import annotations

import dataclasses
import re

import yaml


@dataclasses.dataclass(frozen=True)
class CvoParams:
    # lengthscale schedule (reference CvoParams.hpp:14-19)
    ell_init_first_frame: float = 0.5
    ell_init: float = 0.5
    ell_min: float = 0.05
    min_ell_iter_limit: int = 1
    ell_max: float = 1.2
    dl: float = 0.0            # adaptive-ell only
    dl_step: float = 0.3
    # kernel shape (reference CvoParams.hpp:20-27)
    sigma: float = 0.1         # geometric kernel signal std
    sp_thres: float = 0.0006   # sparsification threshold on the kernel value
    c: float = 7.0             # so(3) flow scale
    d: float = 7.0             # R^3 flow scale
    c_ell: float = 0.15        # color kernel lengthscale
    c_sigma: float = 0.6       # color kernel signal std
    s_ell: float = 0.1         # semantic kernel lengthscale
    s_sigma: float = 0.8       # semantic kernel signal std
    # iteration control (reference CvoParams.hpp:28-33)
    MAX_ITER: int = 10000
    eps: float = 0.00005       # flow-norm convergence threshold
    eps_2: float = 0.000012    # se(3) step-distance convergence threshold
    min_step: float = 2e-5
    max_step: float = 0.8      # clamp ceiling of the step size
    step: float = 0.0
    # neighbor cap / ell decay (reference CvoParams.hpp:35-43)
    nearest_neighbors_max: int = 512
    ell_decay_rate: float = 0.9
    ell_decay_rate_first_frame: float = 0.99
    ell_decay_start: int = 30
    ell_decay_start_first_frame: int = 300
    indicator_window_size: int = 15
    indicator_stable_threshold: float = 0.2
    # feature switches (reference CvoParams.hpp:46-59)
    is_pcl_visualization_on: int = 0
    is_using_least_square: int = 0
    is_ell_adaptive: int = 0
    is_full_ip_matrix: int = 0
    is_using_geometry: int = 1
    is_using_intensity: int = 0
    is_using_semantics: int = 0
    is_using_range_ell: int = 0
    is_using_kdtree: int = 0
    is_exporting_association: int = 0
    is_using_geometric_type: int = 0
    # multiframe IRLS BA (reference CvoParams.hpp:62-75)
    multiframe_using_cpu: int = 1
    multiframe_max_iters: int = 200
    multiframe_ell_init: float = 0.15
    multiframe_ell_min: float = 0.05
    multiframe_iter_per_ell: int = 10
    multiframe_ell_decay_rate: float = 0.7
    multiframe_iterations_per_ell: int = 50
    multiframe_iterations_per_solve: int = 8
    multiframe_expected_points: int = 1000
    multiframe_downsample_voxel_size: float = 0.5
    multiframe_num_neighbors: int = 128
    multiframe_least_squares_num_threads: int = 24
    multiframe_min_nonzeros: int = 300

    def replace(self, **kw) -> "CvoParams":
        return dataclasses.replace(self, **kw)

    def first_frame(self) -> "CvoParams":
        """Parameter swap used for the sequence-start frame
        (main_cvo_gpu_align_raw_image.cpp:40-46)."""
        return self.replace(
            ell_init=self.ell_init_first_frame,
            ell_decay_rate=self.ell_decay_rate_first_frame,
            ell_decay_start=self.ell_decay_start_first_frame,
        )


# The frame-to-frame bench preset. The reference's geometric YAML
# (cvo_geometric_params_img_gpu0.yaml) is not part of this repository, so
# the bench workload runs on the C++ constructor defaults with the
# geometric channel on, under a name of its own.
KITTI_GEOMETRIC_BENCH = CvoParams()

# The colour workload of the dense backend: the bench preset with the
# intensity channel on (the reference's colour YAML is not in this
# repository either). Clouds carry FEATURE_DIMENSIONS = 5 channels per point.
KITTI_COLOR_BENCH = KITTI_GEOMETRIC_BENCH.replace(is_using_intensity=1)

_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(CvoParams)}


def read_cvo_params_yaml(path: str) -> CvoParams:
    """Load a reference-format YAML preset (reference CvoParams.hpp:193-303).

    Accepts plain YAML and OpenCV-style files that begin with a '%YAML:1.0'
    directive. Unknown keys are ignored; missing keys keep their defaults.
    """
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML[^\n]*\n", "", text)
    data = yaml.safe_load(text) or {}
    kw = {}
    for key, value in data.items():
        if key not in _FIELD_TYPES:
            continue
        want = _FIELD_TYPES[key]
        if want in ("int", int):
            if isinstance(value, bool):
                value = int(value)
            elif isinstance(value, str):
                value = int(value.strip().lower() in ("true", "1", "yes"))
            else:
                value = int(value)
        elif want in ("float", float):
            value = float(value)
        kw[key] = value
    return CvoParams().replace(**kw)
