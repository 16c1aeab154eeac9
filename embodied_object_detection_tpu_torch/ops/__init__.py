"""Device ops: hand-written kernels beside their plain PyTorch versions.

Importing the package registers every kernel wrapper's custom op
(`torch.ops.eodt.*`), which is all a program exported by
`serve/export.py` needs to load and run.
"""

from . import (centernet, mask_paste, memory_ops,  # noqa: F401
               ms_deform_attn, nms, roi_align, segment_sum)
from .mask_paste import paste_masks  # noqa: F401
from .nms import class_aware_nms, nms_padded  # noqa: F401
from .roi_align import multilevel_roi_align  # noqa: F401
