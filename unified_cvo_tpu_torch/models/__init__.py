"""models of the PyTorch/CUDA port."""

from unified_cvo_tpu_torch.models.align import (
    AlignInfo, align, compute_association, compute_association_non_isotropic,
    function_angle, inner_product)

__all__ = ["AlignInfo", "align", "compute_association",
           "compute_association_non_isotropic", "function_angle", "inner_product"]
