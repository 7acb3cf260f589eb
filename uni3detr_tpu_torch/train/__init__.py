"""Decode and post-processing of the port (training comes later)."""
