"""Parallelism on `torch.distributed`: the process mesh and its
collectives (`mesh`), the sharded episode runner (`eval_step`) and the
training step, data-parallel over a mesh (`train_step`)."""
