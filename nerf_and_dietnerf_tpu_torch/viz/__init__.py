"""Visualization: epoch plots, per-ray diagnostics, videos, depth maps."""
