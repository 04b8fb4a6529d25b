"""Model modules (T2S: serving, full-eval and training)."""
