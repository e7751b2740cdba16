"""Checkpoint readers and option parsing."""
