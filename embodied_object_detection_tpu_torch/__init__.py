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
                             checkpoints and memory snapshots, the
                             training loop, the serial evaluation protocol
                             (engine/eval.py:evaluate_dataset)
  data/                      the h5 episode dataset and its prefetcher,
                             synthetic episodes and training batches made
                             from a seed, the vendored class table
  evaluation/coco_eval.py    COCO bbox AP on the host
  native/                    its C++ core (g++ + ctypes, built on first use)
  convert/                   carry the JAX package's parameters across
                             (from_jax.py), load detectron2 .pth files
                             (torch_weights.py)
  geometry/projector.py      depth + pose -> map cell ids, on the device
  demo/                      the streaming predictor with its memory
                             (EmbodiedPredictor, AsyncPredictor), the
                             robot and image demos, the cog-style
                             Predictor, the visualizer; zero-shot
                             classifier weights
  serve/                     the HTTP server and the frame step's
                             torch.export program
  data/catalog.py            built-in vocabularies (class names, tables)
  run.py                     the CLI: --eval-only, --dry-run
  kernels/build.py           nvcc build + ctypes binding of csrc/*.cu

Entry points run on the card ("cuda") unless the caller passes
device="cpu", where every kernel wrapper takes its plain PyTorch version.
"""
