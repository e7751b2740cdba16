"""Whole-image inference helpers."""
