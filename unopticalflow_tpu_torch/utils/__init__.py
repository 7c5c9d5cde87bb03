"""Device selection, weight conversion and checkpoint loading."""
