"""Measurement probes: entry points that time the kernels' variants on a card."""
