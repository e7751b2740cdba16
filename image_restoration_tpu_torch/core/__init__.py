"""The launcher and the mesh over ranks (image_restoration_tpu/core)."""
