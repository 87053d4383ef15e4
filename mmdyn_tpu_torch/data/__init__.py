"""The data pipeline: compiling simulator dumps into a corpus (host work:
PIL or the native ingest library), the corpus reader, the synthetic dumps
and corpus writers, the train / test splits and the batch loader with its
prefetch to the card."""
