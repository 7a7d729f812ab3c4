"""Input data for the port (synthetic batches; the dataset loader is
not ported yet)."""
