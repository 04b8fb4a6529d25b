"""Model modules (the T2S serving slice)."""
