"""Device-resident index: stores, manifest, synthetic corpora, conversion."""
