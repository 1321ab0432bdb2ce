"""Measurement scripts for the card, run as files (``python visual_rag_tpu_torch/tools/...``)."""
