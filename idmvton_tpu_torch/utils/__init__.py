"""Utilities: image-quality metrics, profiling, the golden-image gate."""
