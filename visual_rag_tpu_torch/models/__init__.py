"""The embedding models (ColSmol-500M, ColPali-v1.3): processors, tokenizer,
ColVLM, the HF and flax parameter converters, the embedder."""
