"""Replay drivers of the port."""
