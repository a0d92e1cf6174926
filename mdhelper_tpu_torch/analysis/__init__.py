"""Ported analyses and the streaming runtime."""
