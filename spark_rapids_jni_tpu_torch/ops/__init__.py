"""Operators of the port over torch tensors."""
