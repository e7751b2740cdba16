"""Evaluation: whole-image inference helpers and the classification
robustness protocol."""
