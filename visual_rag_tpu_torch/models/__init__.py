"""The ColSmol embedding model: processors, tokenizer, ColVLM, embedder."""
