"""A run with the timed path broken underneath must come out not correct:
the cell's miniature on the CPU, the harness's look for a card skipped,
each fault the cell can have planted in the port, the check held to the
cell's own limits. (One card: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import common

SEED = 2 ** 35 + 9


def run_cell(name):
    cell = common.miniature(common.find_cell(name))
    kind = common.traffic_kind(cell)
    result, checks, _ = kind.run(cell, SEED, 0.5, False, False, "cpu")
    return result, checks


def frozen_memory(monkeypatch):
    """The runner's episode returns the memory it was given."""
    from embodied_object_detection_tpu_torch.models import detector
    make = detector.make_batched_episode_runner

    def broken(model, cfg):
        episode = make(model, cfg)

        def run(frames, zs, memory):
            return episode(frames, zs, memory)._replace(
                memory=memory, first_memory=memory)
        return run
    monkeypatch.setattr(detector, "make_batched_episode_runner", broken)


def half_streams(monkeypatch):
    """Only the first half of the streams is run; the others return no
    detections and their memory unchanged."""
    from embodied_object_detection_tpu_torch.models import detector
    make = detector.make_batched_episode_runner

    def broken(model, cfg):
        episode = make(model, cfg)

        def run(frames, zs, memory):
            b = frames.image.shape[0] // 2
            half = type(frames)(*(None if x is None else x[:b]
                                  for x in frames))
            out = episode(half, zs, type(memory)(*(x[:b] for x in memory)))

            def pad(x, rest):
                return torch.cat([x, rest], 0)
            dets = type(out.detections)(*(
                pad(x, torch.zeros_like(x[:1]).expand(
                    frames.image.shape[0] - b, *x.shape[1:]))
                for x in out.detections))
            mem = type(memory)(*(pad(x, m[b:]) for x, m in
                                 zip(out.memory, memory)))
            return out._replace(detections=dets, memory=mem,
                                first_memory=mem)
        return run
    monkeypatch.setattr(detector, "make_batched_episode_runner", broken)


def altered_scores(monkeypatch):
    """Each frame's detection scores altered where the frame makes them."""
    from embodied_object_detection_tpu_torch.models import detector
    step = detector.EmbodiedDetector.frame_step

    def broken(self, *a, **k):
        out = step(self, *a, **k)
        d = out.detections
        return out._replace(detections=d._replace(scores=d.scores * 0.8))
    monkeypatch.setattr(detector.EmbodiedDetector, "frame_step", broken)


def altered_some_scores(monkeypatch):
    """Every fifth detection's score altered where the frame makes it."""
    from embodied_object_detection_tpu_torch.models import detector
    step = detector.EmbodiedDetector.frame_step

    def broken(self, *a, **k):
        out = step(self, *a, **k)
        d = out.detections
        hit = torch.arange(d.scores.shape[-1]) % 5 == 0
        scores = torch.where(hit.to(d.scores.device), d.scores * 0.8,
                             d.scores)
        return out._replace(detections=d._replace(scores=scores))
    monkeypatch.setattr(detector.EmbodiedDetector, "frame_step", broken)


def write_misses_cells(monkeypatch):
    """The memory write leaves out every eighth cell's features."""
    from embodied_object_detection_tpu_torch.models import detector
    write = detector.memory_write

    def broken(*a, **k):
        out = write(*a, **k)
        upd = out.features_update.clone()
        upd[::8] = 0
        return out._replace(features_update=upd)
    monkeypatch.setattr(detector, "memory_write", broken)


@pytest.mark.parametrize("fault", [frozen_memory, half_streams,
                                   altered_scores, altered_some_scores,
                                   write_misses_cells])
def test_episode_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_cell("r50mem-eval-8x20")
    assert result["correct"] is False, checks


def unchanged_state(monkeypatch):
    """The optimizer step leaves the parameters as they were."""
    from embodied_object_detection_tpu_torch.engine import solver
    monkeypatch.setattr(solver.GroupedOptimizer, "step",
                        lambda self: None)


def parameters_not_written(monkeypatch):
    """The optimizer step updates its moments but never writes the
    parameters."""
    from embodied_object_detection_tpu_torch.engine import solver
    step = solver.GroupedOptimizer.step

    def broken(self):
        before = [p.detach().clone() for p in self.params]
        step(self)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(b)
    monkeypatch.setattr(solver.GroupedOptimizer, "step", broken)


def custom_multiplier_ignored(monkeypatch):
    """The optimizer step applies the base lr to every group, the custom
    group's multiplier left out."""
    from embodied_object_detection_tpu_torch.engine import solver
    step = solver.GroupedOptimizer.step

    def broken(self):
        self.mults = [1.0] * len(self.mults)
        step(self)
    monkeypatch.setattr(solver.GroupedOptimizer, "step", broken)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from embodied_object_detection_tpu_torch.parallel import train_step
    losses = train_step.batch_losses

    def broken(model, cfg, batch, *a, **k):
        w = batch.weight.clone()
        w[w.shape[0] // 2:] = 0
        return losses(model, cfg, batch._replace(weight=w), *a, **k)
    monkeypatch.setattr(train_step, "batch_losses", broken)


def altered_loss(monkeypatch):
    """The loss altered where the step makes it."""
    from embodied_object_detection_tpu_torch.parallel import train_step
    losses = train_step.batch_losses

    def broken(*a, **k):
        total, parts = losses(*a, **k)
        return total * 1.1, parts
    monkeypatch.setattr(train_step, "batch_losses", broken)


@pytest.mark.parametrize("fault", [unchanged_state, parameters_not_written,
                                   custom_multiplier_ignored, half_batch,
                                   altered_loss])
def test_training_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_cell("r50mem-train-2x20")
    assert result["correct"] is False, checks
