"""Training data: the deterministic synthetic token stream
(``synthetic``)."""
