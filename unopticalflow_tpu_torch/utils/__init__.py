"""Device selection, config, logging, weight conversion and checkpoints."""
