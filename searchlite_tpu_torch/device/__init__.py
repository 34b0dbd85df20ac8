"""Segment state as torch tensors."""
