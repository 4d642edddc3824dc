"""Training: the optimizer, schedules, data, checkpoints and the trainer
(the torch twin of ``repro/train/``; ``compression.py``, a ``shard_map``
all-gather over a mesh axis, waits for the port's sharding)."""
