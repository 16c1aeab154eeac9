"""Named spans of the port's work, on the profiler's clock.

`span(name, clock=None)` marks a block of the program:

- while `torch.profiler` records, the block is a `record_function` range
  named `name`: it lands in the same chrome trace as the kernels, on the
  same clock, and the launches inside it carry correlation ids that tie
  each device op to it;
- with a `clock` dict, the block's host seconds are added to
  `clock[name]`, whether or not a profiler records (only loop-level
  spans pass one);
- otherwise, and while `torch.compile` or `torch.export` traces the
  code, `span` returns one shared no-op context: it asks whether a
  compiler traces and whether a profiler records, and allocates
  nothing, so an exported frame holds no profiler op.

Parentage is the nesting on the calling thread; the profiler's chrome
trace is the exporter and the `clock` dict the in-memory total. Span
names start with "eodt." (never "eodt::", the custom ops' namespace).
The spans of the main path:

    eodt.trunk                  EmbodiedDetector.backbone_raw
    eodt.stream_step            one stream's frame in an episode runner;
                                its self part is the memory carry
      eodt.frame                EmbodiedDetector.frame_step, in five parts:
        eodt.frame.fpn          memory read, FPN with the memory merge
        eodt.frame.proposals    CenterNet and its decoding
          eodt.frame.proposals.packed
                                the tower, heads and decode on one canvas
                                (CenterNetHead.proposals; also outside a
                                frame wherever the head packs)
        eodt.frame.cascade      the cascade heads
        eodt.frame.detect       score combination and multiclass NMS
        eodt.frame.write        the memory write (or its zero fill)
    eodt.detr.trunk             DeformableDetrDetector.levels: the trunk
                                and the extra level, over a batch
    eodt.detr.encoder / .two_stage / .decoder
                                DeformableDETR.forward, a frame: input
                                projections and encoder layers; the
                                query seeding (two-stage: the head over
                                every token and its top-k); the decoder
                                layers and their heads
    eodt.detr.post              DeformableDetrDetector.detect's top-k over
                                the batch (detr_inference)
    eodt.to_device              engine/eval.py:frames_to_device
    eodt.eval.data / .compute / .score   the eval loops' chunk timers
    eodt.h2d                    parallel/train_step.py:batch_to_device
    eodt.train.forward / .backward / .allreduce / .optimizer
                                one optimizer step (make_loss_step)
    eodt.train.data / .step     engine/train.py's step timers
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


# the span that does nothing: one shared object, which torch.compile
# also knows how to enter
OFF = contextlib.nullcontext()


class _Clocked:
    """A span that adds its host seconds to clock[name], inside a profiler
    range when one records."""
    __slots__ = ("name", "clock", "range", "t0")

    def __init__(self, name: str, clock: Dict[str, float], profiled: bool):
        self.name, self.clock = name, clock
        self.range = torch.profiler.record_function(name) if profiled \
            else None
        self.t0 = 0.0

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self.clock[self.name] = self.clock.get(self.name, 0.0) + \
            time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _profiled() -> bool:
    return not torch.compiler.is_compiling() and \
        torch.autograd._profiler_enabled()


def span(name: str, clock: Optional[Dict[str, float]] = None):
    """A context that marks the block as `name` (see the module's
    docstring)."""
    if clock is not None:
        return _Clocked(name, clock, _profiled())
    if torch.compiler.is_compiling() or \
            not torch.autograd._profiler_enabled():
        return OFF
    return torch.profiler.record_function(name)
