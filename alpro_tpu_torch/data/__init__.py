"""Host data path of the eval protocols: tokenizer, frame sampling, transforms, datasets, loader."""
