"""Algorithms used by the ported analyses."""
