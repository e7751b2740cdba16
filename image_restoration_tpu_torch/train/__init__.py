"""The training runtime: losses, schedules, recipes, the trainer, checkpoints
and the progressive schedule (image_restoration_tpu/train)."""
