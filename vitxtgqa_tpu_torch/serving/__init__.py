"""Dynamic-batching serving engine."""
