"""Retrieval serving in PyTorch: the inference functions and ``RetrievalIndex``."""
