"""One module a model family: sizes, seeded weights and model FLOPs."""
