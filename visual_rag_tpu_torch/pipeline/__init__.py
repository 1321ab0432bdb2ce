"""Ingest: a page's embeddings to the collection's named vectors."""
