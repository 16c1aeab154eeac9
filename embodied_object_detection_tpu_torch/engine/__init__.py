"""Engine: solver, checkpoints, the training loop and the evaluation
engine. `evaluate_dataset` and `EvalResults` resolve on first use (the
evaluation imports the data layer, which imports the training step)."""

__all__ = ["EvalResults", "evaluate_dataset"]


def __getattr__(name):
    if name in __all__:
        from . import eval as _eval
        return getattr(_eval, name)
    raise AttributeError(name)
