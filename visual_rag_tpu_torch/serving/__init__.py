"""In-process serving layer: HTTP API with dynamic request batching."""
