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
                             runner, the training losses (with Detic's
                             image-label and caption losses)
  parallel/train_step.py     the batch loss and optimizer step, the
                             caption, captiontag and image-label steps
  engine/                    solver (AdamW groups, schedules, clipping),
                             checkpoints and memory snapshots, the
                             training loop, the serial evaluation protocol
                             (engine/eval.py:evaluate_dataset), the
                             single-frame COCO batches and evaluation
                             (engine/coco.py)
  data/                      the h5 episode dataset and its prefetcher,
                             synthetic episodes and training batches made
                             from a seed, the vendored class table; the
                             dataset catalog, COCO-json dataset and
                             multi-dataset sampler (catalog.py), the
                             resize-crop and multi-source mapper
                             (augment.py), the tar ImageNet reader
  evaluation/                COCO bbox AP on the host (coco_eval.py), the
                             OpenImages evaluator (oid_eval.py)
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
  run.py                     the CLI: training, --eval-only, --dry-run,
                             --coco-json
  kernels/build.py           nvcc build + ctypes binding of csrc/*.cu
  tools/dataset_prep.py      the dataset-prep CLI (frequency tables,
                             vocabularies' zs_weight from the CLIP text
                             tower, LVIS / COCO / CC3M / ImageNet jsons)

Entry points run on the card ("cuda") unless the caller passes
device="cpu", where every kernel wrapper takes its plain PyTorch version.
"""
