"""Model configurations (torch dtypes)."""
