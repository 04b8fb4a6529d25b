"""Attention, masks, gumbel utilities and the kernel wrappers."""
