"""embodied_object_detection_tpu_torch -- the PyTorch + CUDA port of
`embodied_object_detection_tpu`, for an NVIDIA H100.

It imports torch and never jax or the JAX package; it keeps its own copy of
what it needs. Module names mirror the JAX package's so that each
counterpart is easy to find:

  config.py, structures.py   dataclass configs, padded containers
  ops/                       segment-sum and memory read (hand-written CUDA
                             kernels in csrc/), memory write, NMS, ROIAlign,
                             mask paste
  models/                    ResNet-50, FPN with memory fusion, CenterNet,
                             cascade heads, the detector and episode runner
  convert/from_jax.py        carry the JAX package's parameters across
  kernels/build.py           nvcc build + ctypes binding of csrc/*.cu

Entry points run on the card ("cuda") unless the caller passes
device="cpu", where every kernel wrapper takes its plain PyTorch version.
"""
