"""embodied_object_detection_tpu_torch -- the PyTorch + CUDA port of
`embodied_object_detection_tpu`, for an NVIDIA H100.

It imports torch and never jax or the JAX package; it keeps its own copy of
what it needs. Module names mirror the JAX package's so that each
counterpart is easy to find:

  config.py, structures.py   dataclass configs, padded containers
  ops/                       memory read and write, NMS, ROIAlign (forward
                             and backward), mask paste: hand-written CUDA
                             kernels in csrc/ beside plain PyTorch versions
  models/                    ResNet-50, FPN with memory fusion, CenterNet,
                             cascade heads, the detector and episode
                             runner, the training losses
  parallel/train_step.py     the batch loss and optimizer step
  engine/                    solver (AdamW groups, schedules, clipping),
                             checkpoints, the training loop
  data/synthetic.py          training batches made from a seed
  convert/from_jax.py        carry the JAX package's parameters across
  kernels/build.py           nvcc build + ctypes binding of csrc/*.cu

Entry points run on the card ("cuda") unless the caller passes
device="cpu", where every kernel wrapper takes its plain PyTorch version.
"""
