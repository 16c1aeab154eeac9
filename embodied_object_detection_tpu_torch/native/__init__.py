"""Host-side compiled components of the port.

  eval_core.cc  IoU + COCO greedy matching + PR-curve sampling (the
                pycocotools C core's analog), the port's own copy of the
                JAX package's

Built lazily with the system g++ into the repository's `build/` and bound
with ctypes: importing this package compiles nothing; the first
`load_eval_core()` (or `native.eval_core`) builds and caches. Without a
toolchain the result is None and the evaluator takes its numpy path.
"""

from .build import load_eval_core

__all__ = ["eval_core", "load_eval_core"]


def __getattr__(name):
    if name == "eval_core":
        return load_eval_core()
    raise AttributeError(name)
