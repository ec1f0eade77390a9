"""TimeSformer, split BERT and the ALPRO retrieval model in PyTorch."""
