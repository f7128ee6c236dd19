"""Error metrics and weight conversion."""
