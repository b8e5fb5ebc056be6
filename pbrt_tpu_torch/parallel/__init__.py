"""Rendering one image over several devices (parallel/shard.py)."""
