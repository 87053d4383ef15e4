"""The compiled corpus: its reader, its synthetic writer, the train / test
splits and the batch loader with its prefetch to the card."""
