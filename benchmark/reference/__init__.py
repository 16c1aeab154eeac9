"""The plain reference the benchmark judges the port against.

`detic_plain/` is a frozen copy of the port's model code: `config.py`,
`structures.py`, `models/` (detector, ResNet-50, Swin-B, FPN, CenterNet,
cascade heads, layers, losses), `ops/` (the memory read and write, NMS,
ROIAlign, mask paste, segment-sum) and `engine/solver.py`, as they stood
when the benchmark was written. It imports nothing of the port. Its
departures from the copied code:

- each kernel wrapper of `ops/` is its plain PyTorch version, on every
  device: the custom ops, their fake implementations and autograd
  registrations, the launch code and the launch counters are gone, and
  with them `kernels/build.py`; the gradients are torch autograd of the
  plain forms (ROIAlign's too);
- the read's gradient checkers and `semmap_classes`, which no reference
  path calls, are gone;
- `parallel/mesh.py` keeps only the two names the ROI heads import;
- `models/layers.py` gains `fp8_at_use()`, the control: every bf16
  convolution and linear layer rounds its input and weight to float8
  e4m3 first;
- `build_detector` lost its Res5 branch.

The benchmark builds the reference with `roi.align_impl="v1"`: the tap
form the port's kernel 4 computes on the card for every impl
(ARCHITECTURE.md, divergence 3b). The plain v4 form is JAX's bf16
re-association, which the card never runs.
"""
