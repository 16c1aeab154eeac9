"""Device ops: hand-written kernels beside their plain PyTorch versions.

Importing the package registers every kernel wrapper's custom op
(`torch.ops.eodt.*`), which is all a program exported by
`serve/export.py` needs to load and run.
"""

from . import (mask_paste, memory_ops, ms_deform_attn,  # noqa: F401
               nms, roi_align, segment_sum)
