"""Device ops (counterpart of pdf_table_tpu/ops): the plain PyTorch ops and
the wrappers of the hand-written kernels (``ops/kernels``).

The JAX package's exports, name for name, each resolved at its first
use."""

from .._lazy import lazy_exports

_EXPORTS = {
    "resize_bilinear": ".image",
    "resize_pad_normalize": ".image",
    "batch_resize_pad_normalize": ".image",
    "normalize_image": ".image",
    "perspective_matrices": ".warp",
    "warp_perspective_batch": ".warp",
    "order_points_clockwise": ".warp",
    "crop_rotated_boxes": ".warp",
    "ctc_greedy_decode": ".ctc",
    "hard_nms": ".nms",
    "nms_mask": ".nms",
    "topk_scores": ".centernet",
    "gather_feat": ".centernet",
    "decode_boxes_4ps": ".centernet",
    "decode_centernet_bbox": ".centernet",
    "heatmap_nms": ".centernet",
    "deform_conv2d": ".deform_conv",
    "component_boxes": ".connected_components",
    "batch_component_boxes_u8": ".connected_components",
}

__all__ = list(_EXPORTS) + ["connected_components"]
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)

# the one export named as its submodule: importing the submodule binds the
# module here, so the function is bound at once (the module imports torch
# only)
from .connected_components import connected_components  # noqa: E402
